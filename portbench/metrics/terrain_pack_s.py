"""terrain_pack_s: host clock around the benchmark's call of the port's
``Terrain.pack(*terrain_bbox(params), device)``, ending in a synchronize."""


def read(ctx):
    return ctx.terrain_pack_s
