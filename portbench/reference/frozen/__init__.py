"""A frozen copy of the plain PyTorch paths of ``atm_raytracer_tpu_torch``
(commit 05461a6), trimmed to the routes the benchmark's cells take:
configuration lowering, atmosphere and refraction table, the RK4 march,
the terrain store and sampling, the Fast generator with its scene objects,
the Rectilinear generator's tilt-0 scan and culled tilted path for opaque
terrain without objects, and compositing. Beside it, copies of commit
f76324c add every other one-card route ``gen`` takes: the Rectilinear
routes for translucent terrain and scene objects with their dispatch
(``generators/rectilinear_routes.py``, ``ops/pixelwise.py``) and the
InterpolatingRectilinear generator (``generators/interpolating.py``). Each
module names its origin in its first line. The copy imports nothing of the
program and launches no kernel. The program may change; this copy does
not."""
