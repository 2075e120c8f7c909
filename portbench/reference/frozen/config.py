# Frozen copy of atm_raytracer_tpu_torch/config.py (commit 05461a6); the benchmark's reference, not the program.
"""Config schema + lowering: a config dict → dataclasses → runtime Params.

Counterpart of ``atm_raytracer_tpu/config.py``: schema-compatible with the
reference YAML grammar (README.md:76-324, src/generator/params.rs:17-505)
including its per-field defaults.

``into_params`` resolves each scene object (``ResolvedObject``): its
altitude against the terrain, and a Billboard's texture loaded as float32
RGBA in [0, 1].
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

from .models.earth import EarthModel
from .ops.coloring import ColoringParams
from .physics.atmosphere import (
    Atmosphere,
    AtmosphereDef,
    atmosphere_def_from_dict,
    us_76,
)

DEFAULT_WAVELENGTH = 530e-9  # params.rs:477-479
DEFAULT_SIM_STEP = 50.0  # params.rs:473-475
GENERATORS = ("Fast", "Rectilinear", "InterpolatingRectilinear")


@dataclasses.dataclass
class Altitude:
    """Absolute meters ASL or Relative to terrain (params.rs:17-30)."""

    kind: str  # "Absolute" | "Relative"
    value: float

    def abs(self, terrain, lat: float, lon: float) -> float:
        if self.kind == "Absolute":
            return self.value
        return terrain.get_elev_or0(lat, lon) + self.value

    @staticmethod
    def from_config(v) -> "Altitude":
        if isinstance(v, dict) and len(v) == 1:
            (k, val), = v.items()
            if k in ("Absolute", "Relative"):
                return Altitude(k, float(val))
        raise ValueError(f"invalid altitude: {v!r}")


@dataclasses.dataclass
class Position:
    latitude: float = 0.0
    longitude: float = 0.0
    altitude: Altitude = dataclasses.field(
        default_factory=lambda: Altitude("Relative", 1.0)
    )  # params.rs:42-44

    def abs_altitude(self, terrain) -> float:
        return self.altitude.abs(terrain, self.latitude, self.longitude)

    @staticmethod
    def from_config(d: dict) -> "Position":
        return Position(
            latitude=float(d.get("latitude", 0.0)),
            longitude=float(d.get("longitude", 0.0)),
            altitude=Altitude.from_config(d["altitude"])
            if "altitude" in d
            else Altitude("Relative", 1.0),
        )


@dataclasses.dataclass
class Color:
    r: float
    g: float
    b: float
    a: float = 1.0  # object/mod.rs:143-145

    @staticmethod
    def from_config(d: dict) -> "Color":
        return Color(float(d["r"]), float(d["g"]), float(d["b"]), float(d.get("a", 1.0)))


@dataclasses.dataclass
class ConfShape:
    """Cylinder/Cone normalize into Frustum (object/mod.rs:42-54)."""

    kind: str  # "Frustum" | "Billboard"
    r1: float = 0.0
    r2: float = 0.0
    height: float = 0.0
    width: float = 0.0
    texture_path: str = ""

    @staticmethod
    def from_config(v: dict) -> "ConfShape":
        (k, d), = v.items()
        if k == "Cylinder":
            return ConfShape("Frustum", r1=float(d["radius"]), r2=float(d["radius"]),
                             height=float(d["height"]))
        if k == "Cone":
            return ConfShape("Frustum", r1=float(d["radius"]), r2=0.0,
                             height=float(d["height"]))
        if k == "Frustum":
            return ConfShape("Frustum", r1=float(d["r1"]), r2=float(d["r2"]),
                             height=float(d["height"]))
        if k == "Billboard":
            return ConfShape("Billboard", width=float(d["width"]),
                             height=float(d["height"]),
                             texture_path=str(d["texture_path"]))
        raise ValueError(f"unknown shape {k!r}")


@dataclasses.dataclass
class ConfObject:
    position: Position
    shape: ConfShape
    color: Color

    @staticmethod
    def from_config(d: dict) -> "ConfObject":
        return ConfObject(
            position=Position.from_config(d["position"]),
            shape=ConfShape.from_config(d["shape"]),
            color=Color.from_config(d["color"]),
        )


@dataclasses.dataclass
class ResolvedObject:
    """Object with terrain-resolved altitude and loaded texture
    (SerializableObject, object/mod.rs:186-215)."""

    kind: str  # "Frustum" | "Billboard"
    lat: float
    lon: float
    elev: float
    color: Color
    r1: float = 0.0
    r2: float = 0.0
    height: float = 0.0
    width: float = 0.0
    texture: Optional[np.ndarray] = None  # [th, tw, 4] float32 0..1
    texture_path: str = ""


def _load_texture(path: str) -> np.ndarray:
    from PIL import Image as PILImage

    img = PILImage.open(path).convert("RGBA")
    return np.asarray(img, np.float32) / 255.0


@dataclasses.dataclass
class ConfScene:
    terrain_folder: str = "./terrain"
    objects: List[ConfObject] = dataclasses.field(default_factory=list)
    terrain_alpha: float = 1.0

    @staticmethod
    def from_config(d: dict) -> "ConfScene":
        return ConfScene(
            terrain_folder=str(d.get("terrain_folder", "./terrain")),
            objects=[ConfObject.from_config(o) for o in d.get("objects", []) or []],
            terrain_alpha=float(d.get("terrain_alpha", 1.0)),
        )


@dataclasses.dataclass
class Frame:
    direction: float = 0.0
    tilt: float = 0.0
    fov: float = 30.0  # params.rs:156-158
    max_distance: float = 150_000.0  # params.rs:160-162

    @staticmethod
    def from_config(d: dict) -> "Frame":
        return Frame(
            direction=float(d.get("direction", 0.0)),
            tilt=float(d.get("tilt", 0.0)),
            fov=float(d.get("fov", 30.0)),
            max_distance=float(d.get("max_distance", 150_000.0)),
        )


@dataclasses.dataclass
class ConfColoring:
    """Simple | Shading (params.rs:176-213)."""

    kind: str = "Shading"
    water_level: float = 0.0
    ambient_light: float = 0.4
    light_zenith_angle: float = 45.0
    light_dir: float = 0.0
    palette: str = "Improved"  # shading.rs:9-14

    @staticmethod
    def from_config(v) -> "ConfColoring":
        if v is None:
            return ConfColoring()
        (k, d), = v.items()
        d = d or {}
        if k == "Simple":
            return ConfColoring(kind="Simple", water_level=float(d.get("water_level", 0.0)))
        if k == "Shading":
            palette = str(d.get("palette", "Improved"))
            if palette not in ("Legacy", "Improved"):
                # serde rejects unknown variants at parse time (shading.rs:9-14)
                raise ValueError(f"unknown palette {palette!r}")
            return ConfColoring(
                kind="Shading",
                water_level=float(d.get("water_level", 0.0)),
                ambient_light=float(d.get("ambient_light", 0.4)),
                light_zenith_angle=float(d.get("light_zenith_angle", 45.0)),
                light_dir=float(d.get("light_dir", 0.0)),
                palette=palette,
            )
        raise ValueError(f"unknown coloring {k!r}")


    def into_coloring(self, frame: Frame, position: Position,
                      model: EarthModel) -> ColoringParams:
        """Lowered coloring (params.rs:229-268): the light vector from the
        zenith angle and an azimuth offset in the observer's view basis."""
        if self.kind == "Simple":
            return ColoringParams(kind="Simple", water_level=self.water_level,
                                  max_distance=frame.max_distance)
        zen = math.radians(self.light_zenith_angle)
        ldir = math.radians(self.light_dir)
        north, east, up = model.world_directions(position.latitude, position.longitude)
        az = math.radians(frame.direction)
        front = north * math.cos(az) + east * math.sin(az)
        right = east * math.cos(az) - north * math.sin(az)
        light = (
            -front * math.sin(zen) * math.cos(ldir)
            + right * math.sin(zen) * math.sin(ldir)
            + up * math.cos(zen)
        )
        light = light / np.linalg.norm(light)
        return ColoringParams(
            kind="Shading",
            water_level=self.water_level,
            ambient_light=self.ambient_light,
            light_dir=tuple(float(v) for v in light),
            palette=self.palette,
        )


@dataclasses.dataclass
class ConfView:
    position: Position = dataclasses.field(default_factory=Position)
    frame: Frame = dataclasses.field(default_factory=Frame)
    coloring: ConfColoring = dataclasses.field(default_factory=ConfColoring)
    fog_distance: Optional[float] = None

    @staticmethod
    def from_config(d: dict) -> "ConfView":
        return ConfView(
            position=Position.from_config(d["position"]) if "position" in d else Position(),
            frame=Frame.from_config(d.get("frame", {}) or {}),
            coloring=ConfColoring.from_config(d.get("coloring")),
            fog_distance=(
                float(d["fog_distance"]) if d.get("fog_distance") is not None else None
            ),
        )


@dataclasses.dataclass
class Tick:
    """Azimuth tick (params.rs:325-338): Single{azimuth} or Multiple{bias,step}."""

    kind: str
    azimuth: float = 0.0
    bias: float = 0.0
    step: float = 0.0
    size: int = 0
    labelled: bool = False

    @staticmethod
    def from_config(v: dict, vertical: bool = False) -> "Tick":
        (k, d), = v.items()
        if k == "Single":
            key = "elevation" if vertical else "azimuth"
            return Tick("Single", azimuth=float(d[key]), size=int(d["size"]),
                        labelled=bool(d["labelled"]))
        return Tick("Multiple", bias=float(d["bias"]), step=float(d["step"]),
                    size=int(d["size"]), labelled=bool(d["labelled"]))


    def angle(self) -> float:
        """The angle whose decimals a label shows (renderer/mod.rs:208-225)."""
        return self.azimuth if self.kind == "Single" else self.step


def _check_generator(name: str) -> str:
    # serde rejects unknown GeneratorDef variants at parse time (params.rs:387-392)
    if name not in GENERATORS:
        raise ValueError(f"unknown generator {name!r}")
    return name


@dataclasses.dataclass
class Output:
    file: str = "./output.png"
    file_metadata: Optional[str] = None
    width: int = 640  # params.rs:419-421
    height: int = 480
    ticks: List[Tick] = dataclasses.field(default_factory=list)
    vertical_ticks: List[Tick] = dataclasses.field(default_factory=list)
    show_eye_level: bool = False
    show_flat_horizon: bool = False
    generator: str = "Fast"  # params.rs:427-429

    @staticmethod
    def from_config(d: dict) -> "Output":
        return Output(
            file=str(d.get("file", "./output.png")),
            file_metadata=d.get("file_metadata"),
            width=int(d.get("width", 640)),
            height=int(d.get("height", 480)),
            ticks=[Tick.from_config(t) for t in d.get("ticks", []) or []],
            vertical_ticks=[
                Tick.from_config(t, vertical=True)
                for t in d.get("vertical_ticks", []) or []
            ],
            show_eye_level=bool(d.get("show_eye_level", False)),
            show_flat_horizon=bool(d.get("show_flat_horizon", False)),
            generator=_check_generator(str(d.get("generator", "Fast"))),
        )


@dataclasses.dataclass
class Config:
    scene: ConfScene = dataclasses.field(default_factory=ConfScene)
    view: ConfView = dataclasses.field(default_factory=ConfView)
    atmosphere: AtmosphereDef = dataclasses.field(default_factory=us_76)
    earth_shape: EarthModel = dataclasses.field(
        default_factory=lambda: EarthModel(kind="Spherical", radius=6_371_000.0)
    )
    wavelength: float = DEFAULT_WAVELENGTH
    straight_rays: bool = False
    simulation_step: float = DEFAULT_SIM_STEP
    output: Output = dataclasses.field(default_factory=Output)

    @staticmethod
    def from_dict(d: dict) -> "Config":
        return Config(
            scene=ConfScene.from_config(d.get("scene", {}) or {}),
            view=ConfView.from_config(d.get("view", {}) or {}),
            atmosphere=atmosphere_def_from_dict(d.get("atmosphere")),
            earth_shape=(
                EarthModel.from_config(d["earth_shape"])
                if "earth_shape" in d
                else EarthModel(kind="Spherical", radius=6_371_000.0)
            ),
            wavelength=float(d.get("wavelength", DEFAULT_WAVELENGTH)),
            straight_rays=bool(d.get("straight_rays", False)),
            simulation_step=float(d.get("simulation_step", DEFAULT_SIM_STEP)),
            output=Output.from_config(d.get("output", {}) or {}),
        )


    def into_params(self, terrain) -> "Params":
        """Lower to runtime Params (params.rs:512-528): each object at its
        absolute altitude, a Billboard with its texture."""
        objects = []
        for o in self.scene.objects:
            objects.append(ResolvedObject(
                kind=o.shape.kind,
                lat=o.position.latitude,
                lon=o.position.longitude,
                elev=o.position.abs_altitude(terrain),
                color=o.color,
                r1=o.shape.r1,
                r2=o.shape.r2,
                height=o.shape.height,
                width=o.shape.width,
                texture=(_load_texture(o.shape.texture_path)
                         if o.shape.kind == "Billboard" else None),
                texture_path=o.shape.texture_path,
            ))
        return Params(
            scene_terrain_folder=self.scene.terrain_folder,
            objects=objects,
            terrain_alpha=self.scene.terrain_alpha,
            view=self.view,
            coloring=self.view.coloring.into_coloring(
                self.view.frame, self.view.position, self.earth_shape
            ),
            model=self.earth_shape,
            atmosphere=Atmosphere(self.atmosphere),
            atmosphere_def=self.atmosphere,
            wavelength=self.wavelength,
            straight_rays=self.straight_rays,
            simulation_step=self.simulation_step,
            output=self.output,
        )


@dataclasses.dataclass
class Params:
    """Lowered runtime parameters (params.rs:496-505)."""

    scene_terrain_folder: str
    objects: List[ResolvedObject]
    terrain_alpha: float
    view: ConfView
    coloring: ColoringParams
    model: EarthModel
    atmosphere: Atmosphere
    atmosphere_def: AtmosphereDef
    wavelength: float
    straight_rays: bool
    simulation_step: float
    output: Output


