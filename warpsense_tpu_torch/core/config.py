"""Typed, layered configuration tree.

Mirrors the reference's ROS-param based ``Params{map, registration, floam,
lidar}`` (include/params/params.h:16-34) including every *derived* field
computed by ``MapParams::load`` (include/params/map_params.h:49-122):

* ``tau = max_distance * 1000``      (mm)
* ``max_weight *= WEIGHT_RESOLUTION``
* ``size_voxels = size_m * 1000 / resolution``
* run ``identifier`` string used for output filenames.

Configs are plain dataclasses loadable from YAML (defaults + per-dataset
override files, replacing the reference's params/*.yaml on the ROS param
server).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Mapping

from .consts import WEIGHT_RESOLUTION


def _double_to_string(d: float) -> str:
    # parity with map_params.h:32-39 ("0.25" -> "0dot25")
    return f"{d:.2f}".replace(".", "dot")


@dataclass
class LidarParams:
    channels: int = 128
    vfov: float = 45.0
    hresolution: int = 1024


@dataclass
class FloamParams:
    pcl_topic: str = "/ouster/points"
    min_distance: float = 2.0
    max_distance: float = 50.0
    edge_resolution: float = 0.4
    edge_threshold: float = 2.5
    surf_resolution: float = 0.8
    surf_threshold: float = 0.001
    optimization_steps: int = 3
    enrich: int = 4
    vgicp_fitness_score: float = 6.0


@dataclass
class RegistrationParams:
    max_iterations: int = 200
    it_weight_gradient: float = 0.1
    lidar_topic: str = "/ouster/points"
    imu_topic: str = "/ouster/imu"
    link: str = "base_link"
    epsilon: float = 0.03
    # GN stepping: "parity" = the reference's un-normalized creep steps;
    # "fast" = true Gauss-Newton (see ops/registration.register_cloud)
    mode: str = "parity"
    # fast mode only: LM iterations run on a 1-in-4 point subsample
    # before switching to full resolution (coarse-to-fine; the
    # per-iteration cost is the latency-bound fields gather)
    coarse_iterations: int = 0
    # fast mode only: freeze the fields gather once the LM step drops
    # below one voxel — the refinement tail iterates on cached per-point
    # fields
    gather_freeze: bool = True
    # fast mode only: seed registration with the previous frame's
    # translation delta (constant-velocity prediction — featsense's
    # odometry has the same prior, odom_estimation.cpp:59-64; the
    # reference warpsense app starts every scan at zero velocity, which
    # in along-axis-degenerate geometry (a corridor) lets the pose slide
    # ~50% behind the motion — measured on the two-room scene, round 5).
    # Rotation still comes from the IMU accumulator.
    velocity_prior: bool = True
    # fast mode only: reject a registration result that moves the pose
    # more than this per scan and keep the prior instead (a 10-20 Hz
    # platform cannot move metres between scans; a degenerate low-count
    # solve CAN — measured at the two-room scene's doorway transition,
    # where an accepted ill-conditioned step teleported the pose ~14 m.
    # Same graceful-degradation pattern as the reference's VGICP fitness
    # gate, vgicp.h:59-63).  <= 0 disables.
    sane_step_m: float = 2.0


@dataclass
class MapParams:
    dir: str = "/tmp"
    comment: str = ""
    max_distance: float = 0.6          # truncation distance tau, meters
    update_distance: float = 0.5       # TSDF update gate, meters
    resolution: int = 64               # voxel edge, millimeters
    size_x: float = 20.0               # window extent, meters
    size_y: float = 20.0
    size_z: float = 5.0
    shift: float = 3.0                 # shift-after-travel, meters
    max_weight: int = 10
    initial_weight: int = 0
    refinement: bool = True
    filename: str = ""

    # ---- derived fields (computed in __post_init__; parity map_params.h:93-122)
    tau: int = field(init=False, default=0)
    max_weight_scaled: int = field(init=False, default=0)
    size_voxels: tuple[int, int, int] = field(init=False, default=(0, 0, 0))

    def __post_init__(self) -> None:
        self.tau = int(self.max_distance * 1000.0)
        self.max_weight_scaled = int(self.max_weight) * WEIGHT_RESOLUTION
        self.size_voxels = (
            int(self.size_x) * 1000 // self.resolution,
            int(self.size_y) * 1000 // self.resolution,
            int(self.size_z) * 1000 // self.resolution,
        )

    def identifier(self) -> str:
        refinement = "loose-vgicp-tpu_" if self.refinement else "vgicp-tpu_"
        comment = "_" if not self.comment else f"_{self.comment}_"
        sv = self.size_voxels
        return (
            "warpsense-tpu" + comment + refinement
            + f"res-{self.resolution}_"
            + f"upd_d-{_double_to_string(self.update_distance)}_"
            + f"max_d-{_double_to_string(self.max_distance)}_"
            + f"max_w-{self.max_weight_scaled}_"
            + f"map-{sv[0]}x{sv[1]}x{sv[2]}"
        )

    def h5_path(self) -> Path:
        if self.filename:
            return Path(self.filename).with_suffix(".h5")
        return Path(self.dir) / (self.identifier() + ".h5")


@dataclass
class Params:
    lidar: LidarParams = field(default_factory=LidarParams)
    floam: FloamParams = field(default_factory=FloamParams)
    registration: RegistrationParams = field(default_factory=RegistrationParams)
    map: MapParams = field(default_factory=MapParams)

    @staticmethod
    def from_dict(cfg: Mapping[str, Any]) -> "Params":
        def build(cls, section: Mapping[str, Any]):
            names = {f.name for f in dataclasses.fields(cls) if f.init}
            kwargs = {}
            for k, v in section.items():
                if k == "size" and isinstance(v, Mapping):
                    for axis in ("x", "y", "z"):
                        if axis in v:
                            kwargs[f"size_{axis}"] = v[axis]
                elif k in names:
                    kwargs[k] = v
            return cls(**kwargs)

        return Params(
            lidar=build(LidarParams, cfg.get("lidar", {})),
            floam=build(FloamParams, cfg.get("floam", {})),
            registration=build(RegistrationParams, cfg.get("registration", {})),
            map=build(MapParams, cfg.get("map", {})),
        )

    @staticmethod
    def preset(name: str | None = None) -> "Params":
        """Load the packaged defaults plus an optional named dataset
        override (warpsense_tpu_torch/configs/<name>.yaml) — the reference's
        params/*.yaml layering without the ROS param server."""
        configs = Path(__file__).resolve().parent.parent / "configs"
        paths = [configs / "default.yaml"]
        if name:
            override = configs / f"{name}.yaml"
            if not override.exists():
                available = sorted(p.stem for p in configs.glob("*.yaml"))
                raise FileNotFoundError(
                    f"unknown preset {name!r}; available: {available}")
            paths.append(override)
        return Params.from_yaml(*paths)

    @staticmethod
    def from_yaml(*paths: str | Path) -> "Params":
        """Load defaults then apply override files left-to-right
        (replacing the reference's per-dataset YAMLs, params/*.yaml)."""
        import yaml

        merged: dict[str, Any] = {}
        for p in paths:
            with open(p) as f:
                doc = yaml.safe_load(f) or {}
            for section, vals in doc.items():
                if isinstance(vals, Mapping):
                    sec = merged.setdefault(section, {})
                    for k, v in vals.items():
                        if k == "size" and isinstance(v, Mapping):
                            sec.setdefault("size", {}).update(v)
                        else:
                            sec[k] = v
                else:
                    merged[section] = vals
        return Params.from_dict(merged)
