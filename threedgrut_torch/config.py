"""Configuration tree for training and rendering; the port's own copy of
threedgrut_tpu/config.py (the same dataclasses, presets, dotted overrides,
to_dict and from_dict), so a checkpoint's .json config reads on either side.

Plain dataclasses + CLI dotted overrides (`a.b.c=value`), no external
dependency.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional, Tuple

from threedgrut_torch import constants as C
from threedgrut_torch.optimizers import OptimizerConfig


@dataclasses.dataclass
class RenderConfig:
    method: str = "3dgut"                 # 3dgut | 3dgrt
    particle_kernel_degree: int = C.KERNEL_DEGREE_3DGUT
    particle_kernel_min_response: float = C.MIN_KERNEL_RESPONSE
    particle_kernel_min_alpha: float = C.MIN_ALPHA
    particle_kernel_max_alpha: float = C.MAX_ALPHA
    min_transmittance: float = C.MIN_TRANSMITTANCE_3DGUT
    # Adaptive kernel clamping (reference configs/render/3dgrt.yaml:6 +
    # particlePrimitives.cu kernelScale): shrink each particle's proxy
    # bounding radius to the iso-surface of min_response/density. Forced on
    # for 3DGRT eval (reference render.py:88-91).
    particle_kernel_density_clamping: bool = False
    tile_culling: bool = True
    # Per-ray re-sorted compositing ("sorted" mode, reference
    # configs/paper/3dgut/base_sorted.yaml k_buffer_size=16): number of
    # odd-even resort passes in the tile kernel; 0 = global depth order
    # (the default).
    k_buffer_passes: int = 0
    ray_jitter: bool = False      # sub-pixel AA jitter during training
    # Train-step backward only: round the per-slot cotangents to bf16
    # before the per-particle f32 sums (ops/sorted_gather.py). Forward
    # images are identical; eval and parity paths use exact f32 (the flag
    # is gated on train).
    low_precision_grads: bool = True
    # Per-pixel last-touch termination: each pixel composites only slots
    # whose PROJECTED footprint (the tile-cull conic/max_power test,
    # reference gutProjector.cuh:49-116, at row granularity) reaches its
    # tile row, and the kernel's window walk stops once every pixel is
    # saturated or past its bound — unsaturated background/gap pixels no
    # longer force their tile to walk its full range. Same approximation
    # family as tile_culling, one level finer (ops/tiles.row_last_touch).
    row_termination: bool = False
    # Train-step backward: bound the cotangent unsort to this fraction of
    # isect_capacity, exploiting the kernel's early exit (never-walked
    # windows carry exactly-zero cotangents, ops/fused_raster.py).
    # Gradients are the same at any value: steps whose walked-window count
    # exceeds the bound take the full-capacity unsort. 0 disables the fused
    # path.
    walk_compact_fraction: float = 0.625
    # Capacity for tile intersections (pairs). Grown on overflow.
    isect_capacity: int = 1 << 21
    # 2DGS barycentric-surfel primitive (reference
    # barycentricSurfelsOptix.cu / gaussianParticles.cuh SurfelPrimitive):
    # response at the canonical z=0 plane intersection.
    surfel_primitive: bool = False


@dataclasses.dataclass
class ModelConfig:
    n_active_features: int = 0            # progressive SH start degree
    max_sh_degree: int = 3
    progressive_sh_interval: int = 1000   # +1 degree every N steps
    background_color: str = "black"       # black | white | random
    default_density: float = 0.1
    capacity: Optional[int] = None        # particle buffer capacity (None=auto)


@dataclasses.dataclass
class StrategyConfig:
    method: str = "gs"                    # gs | mcmc | none
    # GS (configs/strategy/gs.yaml)
    densify_start: int = 500
    densify_end: int = 15000
    densify_frequency: int = 300
    densify_grad_threshold: float = 2e-4
    densify_scale_threshold: float = 0.01   # relative to scene extent
    prune_density_threshold: float = 0.005
    prune_scale_threshold: float = 0.0      # screen-size prune (0 = off)
    # Weight-contribution prune (reference gs.py:205-221 + gs.yaml
    # prune_weight — default-disabled there; threshold applies to a rolling
    # EMA of the kernel's hit-based contribution flag).
    prune_weight_frequency: int = -1        # <= 0 = off (reference default)
    prune_weight_start: int = 500
    prune_weight_threshold: float = 0.5
    prune_weight_ema: float = 0.9
    reset_density_frequency: int = 3000
    reset_density_value: float = 0.01
    density_decay_frequency: int = 0      # 0 = off (reference default off)
    density_decay_gamma: float = 0.9
    split_n: int = 2
    split_scale_divisor: float = 1.6
    # MCMC (configs/strategy/mcmc.yaml)
    mcmc_opacity_threshold: float = 0.005
    mcmc_noise_lr: float = 5e5
    mcmc_add_frequency: int = 100
    mcmc_add_fraction: float = 0.05
    mcmc_max_gaussians: int = 1_000_000
    mcmc_binom_n_max: int = 51


@dataclasses.dataclass
class LossConfig:
    lambda_l1: float = 0.8
    lambda_l2: float = 0.0
    lambda_ssim: float = 0.2
    use_mask: bool = False


@dataclasses.dataclass
class DatasetConfig:
    type: str = "nerf"                    # nerf | colmap | scannetpp | synthetic
    path: str = ""
    downsample_factor: int = 1
    test_split_interval: int = 8          # colmap val split
    bg_color: Optional[Tuple[float, float, float]] = None
    # Sensor shutter model (reference drives this from per-camera sensor
    # metadata, threedgut_tracer/tracer.py:138-151 + camera_models.py
    # ShutterType; COLMAP/NeRF formats carry no timestamps, so start==end
    # pose unless the dataset supplies per-frame end poses). Either one
    # name applied to every sensor — global | rolling_top_to_bottom |
    # rolling_left_to_right | rolling_bottom_to_top |
    # rolling_right_to_left — or a per-camera-id mapping for multi-sensor
    # COLMAP rigs, as "1:global,2:rolling_top_to_bottom" (dotted-override
    # friendly) or a {camera_id: name} dict programmatically.
    shutter_type: str = "global"
    # dataset.type=synthetic knobs (procedural scenes; no files needed).
    synthetic_views: int = 12
    synthetic_resolution: int = 64        # square W=H
    synthetic_gt: int = 96                # GT Gaussians
    synthetic_multi_sensor: bool = False  # pinhole+fisheye rig, rolling
                                          # shutter, vignette masks


@dataclasses.dataclass
class TrainConfig:
    iterations: int = 30000
    checkpoint_iterations: Tuple[int, ...] = (7000, 30000)
    val_frequency: int = 5000
    print_frequency: int = 100
    seed: int = 0


@dataclasses.dataclass
class Config:
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    strategy: StrategyConfig = dataclasses.field(default_factory=StrategyConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    out_dir: str = "runs"
    experiment_name: str = "experiment"
    resume: str = ""


# ---------------------------------------------------------------------------
# Presets (the reference's configs/apps/*.yaml)
# ---------------------------------------------------------------------------

def preset_3dgut() -> Config:
    return Config()


def preset_3dgrt() -> Config:
    cfg = Config()
    cfg.render.method = "3dgrt"
    cfg.render.particle_kernel_degree = C.KERNEL_DEGREE_3DGRT
    cfg.render.min_transmittance = C.MIN_TRANSMITTANCE_3DGRT
    return cfg


def preset_mcmc(base: Optional[Config] = None) -> Config:
    cfg = base or Config()
    cfg.strategy.method = "mcmc"
    # configs/strategy/mcmc.yaml: relocation/growth run in [500, 25000].
    cfg.strategy.densify_end = 25000
    return cfg


def preset_3dgut_sorted() -> Config:
    """Per-ray re-sorted ("sorted") 3DGUT mode: the reference's paper config
    configs/paper/3dgut/base_sorted.yaml sets k_buffer_size=16; here 16
    odd-even resort passes bound per-ray displacement by 16 slots."""
    cfg = Config()
    cfg.render.k_buffer_passes = 16
    return cfg


PRESETS = {
    "nerf_synthetic_3dgut": preset_3dgut,
    "nerf_synthetic_3dgrt": preset_3dgrt,
    "colmap_3dgut": preset_3dgut,
    "colmap_3dgrt": preset_3dgrt,
    "scannetpp_3dgut": preset_3dgut,
    "scannetpp_3dgrt": preset_3dgrt,
    # MCMC app presets (reference configs/apps/{colmap_3dgut_mcmc,
    # colmap_3dgrt_mcmc}.yaml: strategy -> mcmc, densify window to 25000).
    "nerf_synthetic_3dgut_mcmc": lambda: preset_mcmc(preset_3dgut()),
    "nerf_synthetic_3dgrt_mcmc": lambda: preset_mcmc(preset_3dgrt()),
    "colmap_3dgut_mcmc": lambda: preset_mcmc(preset_3dgut()),
    "colmap_3dgrt_mcmc": lambda: preset_mcmc(preset_3dgrt()),
    # Paper "sorted" mode (configs/paper/3dgut/base_sorted.yaml).
    "nerf_synthetic_3dgut_sorted": preset_3dgut_sorted,
    "colmap_3dgut_sorted": preset_3dgut_sorted,
}


def make(name: str = "nerf_synthetic_3dgut", overrides=()) -> Config:
    cfg = PRESETS[name]()
    # Selecting the MCMC strategy by override pulls in its window defaults
    # first (the reference's strategy/mcmc.yaml group brings its own
    # densify_end=25000); explicit dotted overrides still win below.
    if any(ov.replace(" ", "").startswith("strategy.method=mcmc")
           for ov in overrides):
        cfg = preset_mcmc(cfg)
    for ov in overrides:
        apply_override(cfg, ov)
    return cfg


def _coerce(old: Any, text: str) -> Any:
    if isinstance(old, bool):
        return text.lower() in ("1", "true", "yes", "on")
    if isinstance(old, int) and not isinstance(old, bool):
        return int(text)
    if isinstance(old, float):
        return float(text)
    if isinstance(old, tuple):
        # Accept JSON lists ("[7000,30000]"), bare comma lists
        # ("7000,30000"), and scalars ("300" -> one-element tuple) — the
        # reference's Hydra accepts the same shapes for list fields.
        try:
            v = json.loads(text)
        except (ValueError, json.JSONDecodeError):
            v = [t for t in text.split(",") if t.strip()]
        if not isinstance(v, (list, tuple)):
            v = [v]
        elem = type(old[0]) if old else float
        return tuple(elem(x) for x in v)
    if old is None:
        try:
            return json.loads(text)
        except (ValueError, json.JSONDecodeError):
            return text
    return text


def apply_override(cfg: Config, override: str) -> None:
    """Apply a Hydra-style dotted override: 'render.method=3dgrt'."""
    key, _, value = override.partition("=")
    obj = cfg
    parts = key.strip().split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    leaf = parts[-1]
    if dataclasses.is_dataclass(obj) and leaf not in {
            f.name for f in dataclasses.fields(obj)}:
        raise KeyError(f"unknown config key {key!r}")
    coerced = _coerce(getattr(obj, leaf, None), value.strip())
    # OptimizerConfig is frozen (its instances are hashable).
    object.__setattr__(obj, leaf, coerced)


def to_dict(cfg: Config) -> dict:
    return dataclasses.asdict(cfg)


_SUBCONFIGS = {
    "render": RenderConfig, "model": ModelConfig, "optimizer": OptimizerConfig,
    "strategy": StrategyConfig, "loss": LossConfig, "dataset": DatasetConfig,
    "train": TrainConfig,
}


def from_dict(d: dict) -> Config:
    def build(cls, dd):
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in dd:
                continue
            v = dd[f.name]
            if f.name in _SUBCONFIGS and cls is Config:
                kwargs[f.name] = build(_SUBCONFIGS[f.name], v)
            elif isinstance(v, list):
                kwargs[f.name] = tuple(v)
            else:
                kwargs[f.name] = v
        return cls(**kwargs)
    return build(Config, d)
