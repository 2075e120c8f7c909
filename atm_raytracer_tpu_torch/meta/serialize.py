"""Metadata artifact: self-contained params + per-pixel trace points.

Counterpart of ``atm_raytracer_tpu/meta/serialize.py``, with its file
formats unchanged, so an artifact written by either package loads in the
other (reference: the gzip(bincode(AllData)) artifact of
src/generator/mod.rs:20-45, read back in src/viewer/mod.rs:12-34).

``fmt="native"`` writes a compressed npz: the config as YAML plus the hits,
enough to re-render and inspect the image without terrain data. Format v2
stores a u32 validity bitmask over the dense [H, W, K] slots and only the
valid slots' fields, compacted in flat C order (41 B per valid slot plus
P/8 bitmask bytes). Every stored value is the exact f32 the render
produced, so re-compositing a loaded artifact gives the render's image bit
for bit. ``distance`` is not stored: it is ``where(valid, key, 0)·step``
on every hit path, and the same f32 expression re-applied on load. Invalid
slots load as canonical fillers (key = +inf, 0 elsewhere). v1 files (dense
planes) stay readable.

``fmt="reference"`` writes the reference binary's gzip(bincode(AllData))
layout through :mod:`.bincode`.

The compaction runs where the hits live (``_pack_artifact``): one index per
field after a single host sync for the count, then one batched fetch of the
bitmask and the fields. Loaded artifacts come back as CPU tensors.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..config import Config
from ..generators.base import HitBuffer, RenderResult, fetch_flat_many

FORMAT_VERSION = 2

# the compacted fields of format v2, in the order the file stores them
PACKED_FIELDS = ("key", "dlat", "dlon", "elevation", "path_length", "normal",
                 "kind", "rgba")


def _pack_artifact(hits: HitBuffer):
    """Valid-slot compaction of every stored field, on the hits' device.

    Returns host arrays: (bits u32 [ceil(P/32)], count, {field: [count,
    ...]}) with the valid slots in flat C order. One host sync learns the
    count; the bitmask (``meta.pack._bitmask``: u32 words as int32 bits)
    and the eight compacted fields then come over in one
    ``fetch_flat_many``. ``kind`` narrows to u8 on the host.
    """
    from .pack import _bitmask, _u32

    vflat = hits.valid.reshape(-1)
    p = vflat.shape[0]
    idx = torch.nonzero(vflat).squeeze(1)  # the one host sync: the count
    n = int(idx.shape[0])
    fields = [getattr(hits, name) for name in PACKED_FIELDS]
    trailing = [x.shape[hits.valid.ndim:] for x in fields]
    bits, *flats = fetch_flat_many(
        [_bitmask(vflat)]
        + [x.reshape((p,) + t).index_select(0, idx) for x, t in zip(fields, trailing)])
    segments = {name: flat.reshape((n,) + t)
                for name, flat, t in zip(PACKED_FIELDS, flats, trailing)}
    segments["kind"] = segments["kind"].astype(np.uint8)
    return _u32(bits), n, segments


def save_metadata(path, config: Config, result: RenderResult,
                  fmt: str = "native", terrain=None) -> None:
    """Write the metadata artifact to exactly ``path``.

    ``fmt="native"``: the npz format above. ``fmt="reference"``: the
    reference binary's gzip(bincode(AllData)) layout; its atmosphere segment
    is a best-effort encoding (see :func:`.bincode.encode_environment`).
    ``terrain`` is needed only for ``reference`` scenes with
    Relative-altitude objects: the reference serializes each object at its
    lowered absolute elevation (object/mod.rs:165-184).
    """
    if fmt == "reference":
        blob = _encode_reference(config, result, terrain)
        with open(path, "wb") as fh:
            fh.write(blob)
        return
    if fmt != "native":
        raise ValueError(f"unknown metadata format {fmt!r}")
    # the exact filename the user gave (np.savez appends .npz to a str path)
    with open(path, "wb") as fh:
        _savez(fh, config, result)


def reference_params_dict(config: Config, terrain=None) -> dict:
    """Lower a Config to the dict tree :func:`.bincode.encode_alldata`
    writes: the reference's post-lowering ``Params`` (params.rs:496-528),
    objects at their absolute elevations (a Relative one resolved on
    ``terrain``), the coloring with its world light vector."""
    from ..physics.atmosphere import atmosphere_def_to_dict
    from .bincode import encode_environment

    objects = []
    for o in config.scene.objects:
        objects.append({
            "position": {
                "lat": o.position.latitude,
                "lon": o.position.longitude,
                "elev": o.position.abs_altitude(terrain)
                if o.position.altitude.kind == "Relative"
                else o.position.altitude.value,
            },
            "shape": (
                {"Frustum": {"r1": o.shape.r1, "r2": o.shape.r2,
                             "height": o.shape.height}}
                if o.shape.kind == "Frustum"
                else {"Billboard": {"width": o.shape.width,
                                    "height": o.shape.height,
                                    "texture_path": o.shape.texture_path}}
            ),
            "color": {"r": o.color.r, "g": o.color.g, "b": o.color.b,
                      "a": o.color.a},
        })
    frame, position = config.view.frame, config.view.position
    lowered = config.view.coloring.into_coloring(frame, position, config.earth_shape)
    if lowered.kind == "Simple":
        coloring = {"Simple": {"water_level": lowered.water_level,
                               "max_distance": lowered.max_distance}}
    else:
        coloring = {"Shading": {
            "water_level": lowered.water_level,
            "ambient_light": lowered.ambient_light,
            "light_dir_world": list(lowered.light_dir),
            "palette": lowered.palette,
        }}
    return {
        "scene": {
            "terrain_folder": config.scene.terrain_folder,
            "objects": objects,
            "terrain_alpha": config.scene.terrain_alpha,
        },
        "view": {
            "position": {
                "latitude": position.latitude,
                "longitude": position.longitude,
                "altitude": {position.altitude.kind: position.altitude.value},
            },
            "frame": {
                "direction": frame.direction, "tilt": frame.tilt,
                "fov": frame.fov, "max_distance": frame.max_distance,
            },
            "coloring": coloring,
            "fog_distance": config.view.fog_distance,
        },
        "model": config.earth_shape.to_config(),
        "env_raw": encode_environment(
            config.earth_shape.to_shape().radius,
            atmosphere_def_to_dict(config.atmosphere), config.wavelength,
        ),
        "straight_rays": config.straight_rays,
        "simulation_step": config.simulation_step,
        "output": config.output.to_config(),
    }


def _encode_reference(config: Config, result: RenderResult, terrain) -> bytes:
    from .bincode import encode_alldata

    params = reference_params_dict(config, terrain)
    elev = np.asarray(result.elevation_deg, np.float64)
    az = np.asarray(result.azimuth_deg, np.float64)
    h, w, _ = result.hits.valid.shape
    if elev.ndim == 1:  # Fast generator: separable angle grids
        elev = np.broadcast_to(elev[:, None], (h, w))
    if az.ndim == 1:
        az = np.broadcast_to(az[None, :], (h, w))
    return encode_alldata(params, elev, az, result.hits.to("cpu"))


def _savez(fh, config: Config, result: RenderResult) -> None:
    import yaml

    bits, n, seg = _pack_artifact(result.hits)
    np.savez_compressed(
        fh,
        format_version=np.int32(FORMAT_VERSION),
        config_yaml=np.frombuffer(
            yaml.safe_dump(config.to_dict()).encode(), dtype=np.uint8
        ),
        observer=np.asarray(result.observer, np.float64),
        elevation_deg=np.asarray(result.elevation_deg, np.float64),
        azimuth_deg=np.asarray(result.azimuth_deg, np.float64),
        shape=np.asarray(result.hits.valid.shape, np.int64),
        bits=bits,
        key=seg["key"].astype(np.float32, copy=False),
        dlat=seg["dlat"].astype(np.float32, copy=False),
        dlon=seg["dlon"].astype(np.float32, copy=False),
        elevation=seg["elevation"].astype(np.float32, copy=False),
        path_length=seg["path_length"].astype(np.float32, copy=False),
        normal=seg["normal"].reshape(n, 3).astype(np.float32, copy=False),
        kind=seg["kind"],
        rgba=seg["rgba"].reshape(n, 4).astype(np.float32, copy=False),
    )


def _unpack_v2(z, step: float) -> HitBuffer:
    """Host inverse of :func:`_pack_artifact`: bitmask → dense planes."""
    from ..ops.combine import NO_HIT

    shape = tuple(int(s) for s in z["shape"])
    p = math.prod(shape)
    bits = np.asarray(z["bits"], np.uint32)
    vflat = (
        (bits[:, None] >> np.arange(32, dtype=np.uint32)) & 1
    ).astype(bool).reshape(-1)[:p]

    def expand(seg, fill, dtype, extra=()):
        out = np.full((p,) + extra, fill, dtype)
        out[vflat] = seg
        return torch.from_numpy(out.reshape(shape + extra))

    valid = vflat.reshape(shape)
    key = expand(z["key"], NO_HIT, np.float32)
    return HitBuffer(
        valid=torch.from_numpy(valid),
        key=key,
        dlat=expand(z["dlat"], 0, np.float32),
        dlon=expand(z["dlon"], 0, np.float32),
        # the hit paths' own expression (module docstring)
        distance=torch.from_numpy(
            (np.where(valid, key.numpy(), np.float32(0.0)) * np.float32(step))
            .astype(np.float32)
        ),
        elevation=expand(z["elevation"], 0, np.float32),
        path_length=expand(z["path_length"], 0, np.float32),
        normal=expand(z["normal"], 0, np.float32, (3,)),
        kind=expand(z["kind"].astype(np.int32), 0, np.int32),
        rgba=expand(z["rgba"], 0, np.float32, (4,)),
    )


def load_metadata(path) -> Tuple[Config, RenderResult]:
    """Load an artifact: a native npz, or a reference bincode ``.dat``.

    The magic bytes decide: zip (``PK``) is the npz; anything else — gzip
    or a raw bincode blob — goes to :mod:`.bincode`. The hits come back as
    CPU tensors and ``image`` as None (the viewer re-composites it).
    """
    import yaml

    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic != b"PK":
        return _load_bincode(path)
    with np.load(path, allow_pickle=False) as z:
        version = int(z["format_version"])
        if version > FORMAT_VERSION:
            raise ValueError(f"metadata format v{version} is newer than supported")
        config = Config.from_dict(yaml.safe_load(bytes(z["config_yaml"]).decode()))
        if version >= 2:
            hits = _unpack_v2(z, float(config.simulation_step))
        else:  # v1: dense [H, W, K] planes stored verbatim
            hits = HitBuffer(**{
                f: torch.from_numpy(z[f]) for f in (
                    "valid", "key", "dlat", "dlon", "distance", "elevation",
                    "path_length", "normal", "kind", "rgba",
                )
            })
        result = RenderResult(
            image=None,
            hits=hits,
            elevation_deg=z["elevation_deg"],
            azimuth_deg=z["azimuth_deg"],
            observer=tuple(z["observer"]),
        )
    return config, result


def _invert_light_dir(light, model, position: dict, direction_deg: float):
    """World light vector → (zenith angle°, light_dir°) that
    ``ConfColoring.into_coloring`` turns back into the same vector.

    The lowering (params.rs:240-258) is light = −front·sinZ·cosL +
    right·sinZ·sinL + up·cosZ in the observer's view basis, so
    Z = acos(light·up), L = atan2(light·right, −light·front).
    """
    north, east, up = model.world_directions(
        position["latitude"], position["longitude"]
    )
    az = math.radians(direction_deg)
    front = north * math.cos(az) + east * math.sin(az)
    right = east * math.cos(az) - north * math.sin(az)
    light = np.asarray(light, np.float64)
    light = light / np.linalg.norm(light)  # lowered vectors are unit (params.rs:257)
    zen = math.degrees(math.acos(float(np.clip(np.dot(light, up), -1, 1))))
    ldir = math.degrees(
        math.atan2(float(np.dot(light, right)), float(-np.dot(light, front)))
    )
    return zen, ldir


def _load_bincode(path) -> Tuple[Config, RenderResult]:
    """The reference artifact's load path (layout in meta/bincode.py)."""
    from ..models.earth import EarthModel
    from .bincode import decode_alldata

    with open(path, "rb") as fh:
        params, elev, az, hits = decode_alldata(fh.read())

    view = params["view"]
    coloring = view["coloring"]
    if "Shading" in coloring:
        s = coloring["Shading"]
        zen, ldir = _invert_light_dir(
            s["light_dir_world"], EarthModel.from_config(params["model"]),
            view["position"], view["frame"]["direction"],
        )
        conf_coloring = {"Shading": {
            "water_level": s["water_level"],
            "ambient_light": s["ambient_light"],
            "light_zenith_angle": zen,
            "light_dir": ldir,
            "palette": s["palette"],
        }}
    else:
        conf_coloring = {"Simple": {"water_level": coloring["Simple"]["water_level"]}}

    objects = [{
        "position": {
            "latitude": ob["position"]["lat"],
            "longitude": ob["position"]["lon"],
            "altitude": {"Absolute": ob["position"]["elev"]},
        },
        "shape": ob["shape"],
        "color": ob["color"],
    } for ob in params["scene"]["objects"]]

    d = {
        "scene": {
            "terrain_folder": params["scene"]["terrain_folder"],
            "objects": objects,
            "terrain_alpha": params["scene"]["terrain_alpha"],
        },
        "view": {
            "position": view["position"],
            "frame": view["frame"],
            "coloring": conf_coloring,
        },
        # the Environment bytes are opaque (meta/bincode.py); the viewer
        # traces no rays, so the default atmosphere stands in
        "earth_shape": params["model"],
        "straight_rays": params["straight_rays"],
        "simulation_step": params["simulation_step"],
        "output": params["output"],
    }
    if view.get("fog_distance") is not None:
        d["view"]["fog_distance"] = view["fog_distance"]
    config = Config.from_dict(d)

    pos = view["position"]
    ((_, alt_value),) = pos["altitude"].items()
    result = RenderResult(
        image=None,
        hits=hits,
        elevation_deg=elev,
        azimuth_deg=az,
        # a Relative altitude needs terrain the artifact does not carry; the
        # reference viewer has the same limitation (unwrap_or(0.0))
        observer=(pos["latitude"], pos["longitude"], float(alt_value)),
    )
    return config, result
