"""Configuration of the port: the fields its paths read (the DOTA family
and the prototype cache, for the three backbones Uni3D, ULIP-2 and
OpenShape).

A copy, not an import, of the dataclasses in `uni_adapter_tpu/config.py`,
with the same names and defaults, cut to what this package runs.
`quantize_int8` is a model variant, not a choice of implementation: it
changes the function (Uni3D's trunk on int8 `QuantDense` layers,
`models/common.py`), and it is kept.  Two differences by design:

  * no kernel-selection fields (`use_pallas_*`, `approx_knn`): the device
    fixes the implementation — CUDA tensors go through the Hopper
    kernels, CPU tensors through their plain PyTorch versions;
  * `--device` defaults to `cuda`, and a run asked for `cuda` on a host
    without a GPU raises instead of falling back to the CPU.

The combinations of `--dist-mode`, `--trunk-parallel`,
`--vmap-corruptions` and `--continual` that the JAX parser rejects raise
its `ValueError` here.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Optional

ASSETS_DIR = os.path.join(os.path.dirname(__file__), "assets")

#: The 15 corruption types of the -C benchmarks.
CORRUPTIONS = (
    "uniform", "gaussian", "background", "impulse", "upsampling",
    "distortion_rbf", "distortion_rbf_inv", "density", "density_inc",
    "shear", "rotation", "cutout", "distortion", "occlusion", "lidar",
)


@dataclass
class ModelConfig:
    vlm3d: str = "uni3d"                 # uni3d | ulip | openshape
    pc_feat_dim: int = 1024              # transformer width (EVA02-L)
    embed_dim: int = 1024                # CLIP embedding dim
    num_group: int = 512
    group_size: int = 64
    pc_encoder_dim: int = 512            # mini-PointNet output channels
    eva_depth: int = 24
    eva_heads: int = 16
    # ULIP-2 / Point-BERT
    ulip_trans_dim: int = 384
    ulip_depth: int = 12
    ulip_heads: int = 6
    ulip_group_size: int = 32
    ulip_encoder_dim: int = 256
    ulip_embed_dim: int = 512
    # OpenShape PPTA
    oshape_version: str = "vitg14"       # vitg14 (scaling 4) | vitl14 (3)
    oshape_clip_dim: int = 1280          # bigG text width
    logit_scale: float = 100.0
    compute_dtype: str = "bfloat16"
    # Uni3D's EVA trunk on int8 QuantDense layers (dynamic per-row and
    # per-column scales, int32 accumulation); the other backbones ignore it
    quantize_int8: bool = False
    # reference-layout torch checkpoints (models/loader.py); random
    # weights from the run's seed otherwise
    checkpoint_path: Optional[str] = None
    clip_checkpoint_path: Optional[str] = None


@dataclass
class DotaConfig:
    use_dota: bool = False
    use_mode_dota: bool = True
    use_gmm_dota: bool = False
    use_adaptive_dota: bool = False
    epsilon: float = 1e-4
    sigma: float = 1e-4
    eta: float = 0.1
    rho: float = 0.02
    mode_M: int = 4
    res_learning: bool = True
    # plain DOTA's prior: this many uniform pseudo-counts blended with the
    # cumulative soft labels (None: no prior)
    prior_pre_steps: Optional[int] = None
    # GMM-DOTA's cap on the empirical class prior's blend weight
    alpha_max: float = 0.5
    noise_std: float = 0.05
    residual_lr: float = 1e-3
    residual_steps: int = 10
    fp16_predict_input: bool = False
    fix_fusion_normalization: bool = False
    # precision of the residual loop's products, forward and backward:
    # 'highest' fp32 (TF32 off), 'high' TF32, 'default' bf16 operands
    # with fp32 sums (adapt/residual.py)
    residual_precision: str = "highest"
    # parsed for the JAX package's flag: it only reshapes XLA's program,
    # and the port's eager loop is the same for both values
    residual_unroll: bool = False


@dataclass
class CacheConfig:
    """Uni-Adapter cache hyperparameters; `Config.resolve` applies the
    reference's per-dataset table."""
    shot_capacity: int = 30
    beta: float = 150.0
    threshold: float = 0.5
    lambda_reg: float = 0.11
    use_new_approximation: bool = True
    cg_max_iter: int = 100
    # parsed, but never passed to the CG, as in the JAX engine: the CG
    # runs at its default tolerance 1e-5
    cg_tol: float = 1e-5
    # 'dense' (the K·C slots are the nodes), 'prototype' (one node a
    # class), 'auto': dense while K·shot_capacity ≤ 4096
    graph_mode: str = "auto"


@dataclass
class DataConfig:
    root: str = ""
    dataset_name: str = "modelnet"       # modelnet | scanobject | shapenetcore
    # labels.json key; None = inferred from dataset_name (`Config.resolve`)
    validate_dataset_name: Optional[str] = None
    template_key: str = "modelnet40_64"
    corruption: str = "all"
    severity: int = 5
    batch_size: int = 1
    npoints: int = 1024
    debug: bool = False
    precomputed_text_features: Optional[str] = None
    labels_path: str = os.path.join(ASSETS_DIR, "labels.json")
    templates_path: str = os.path.join(ASSETS_DIR, "templates.json")


@dataclass
class RunConfig:
    name: Optional[str] = None
    output_dir: str = "./outputs"
    seed: int = 42
    print_freq: int = 100
    device: str = "cuda"                 # cuda | cpu
    # each stream through `engine.run_stream_scan` (on the card: one step
    # captured as a CUDA graph and replayed); false: the eager step loop
    use_scan: bool = True
    vmap_corruptions: bool = False
    continual: bool = False
    # replicated | sharded | psum (parallel/mesh.py, under a multi-process
    # launch) | ep (the class axis over the ranks, parallel/ep.py)
    dist_mode: str = "replicated"
    # ep: each rank also encodes ⌈2B/n⌉ rows of MODE-DOTA's fused batch
    ep_shard_encoder: bool = False
    # the JAX mesh's data axis name: accepted for the JAX command line and
    # ignored (the port's DP × EP grid is of process groups,
    # `parallel/ep.make_grid`)
    data_axis: str = "data"
    # none | tp: the encoder trunk tensor-parallel over the whole world
    # (parallel/tp.py; every backbone) | pp: pipeline stages over the
    # first `trunk_stages` ranks (parallel/pp.py; every backbone) | sp:
    # the tokens sharded over the whole world, exact ring attention
    # (parallel/sp.py; Uni3D and ULIP-2); the adaptation replicated
    trunk_parallel: str = "none"
    # pp: the number of pipeline stages (default: the whole world); the
    # trunk depth must divide by trunk_stages × pp_interleave
    trunk_stages: Optional[int] = None
    # pp: virtual chunks a stage (the interleaved schedule,
    # parallel/pp_interleave.py)
    pp_interleave: int = 1
    # a torch.profiler trace (CPU and CUDA) of the corruption loop, written
    # into this directory (`utils/profiling.trace`); None: no trace
    profile_dir: Optional[str] = None


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    dota: DotaConfig = field(default_factory=DotaConfig)
    cache: CacheConfig = field(default_factory=CacheConfig)
    data: DataConfig = field(default_factory=DataConfig)
    run: RunConfig = field(default_factory=RunConfig)

    def resolve(self) -> "Config":
        """Apply the reference's per-dataset cache hyperparameters and infer
        the labels.json key from the dataset name when it is not set;
        families it cannot infer (OmniObject3D) keep None, and
        `load_labels` raises only if their labels are needed."""
        name = self.data.dataset_name.lower()
        c = dataclasses.replace(self.cache)
        if "modelnet" in name:
            c.lambda_reg, c.threshold = 0.11, 0.5
        elif "scanobject" in name:
            c.lambda_reg, c.threshold = 0.20, 0.5
        elif "shapenet" in name:
            c.lambda_reg, c.threshold = 0.07, 0.45
            c.use_new_approximation = False
        d = self.data
        if d.validate_dataset_name is None:
            try:
                d = dataclasses.replace(
                    d, validate_dataset_name=labels_key_for(d.dataset_name))
            except ValueError:
                pass
        return dataclasses.replace(self, cache=c, data=d)


def get_hyperparams(dataset_name: str) -> dict:
    """The cache hyperparameters of a dataset family, as a dict."""
    cfg = Config(data=DataConfig(dataset_name=dataset_name)).resolve()
    return {"shot_capacity": cfg.cache.shot_capacity,
            "beta": cfg.cache.beta,
            "threshold": cfg.cache.threshold,
            "lambda_reg": cfg.cache.lambda_reg,
            "use_new_approximation": cfg.cache.use_new_approximation}


def labels_key_for(dataset_name: str) -> str:
    """labels.json key for a dataset family."""
    name = dataset_name.lower()
    if "modelnet" in name:
        return "modelnet40_openshape"
    if "scanobject" in name:
        return "scanobjnn_openshape"
    if "shapenet" in name:
        return "shapenet_openshape"
    if "lvis" in name or "objaverse" in name:
        return "objaverse_lvis_openshape"
    raise ValueError(f"cannot infer a labels.json key for dataset "
                     f"{dataset_name!r}; set the key explicitly "
                     f"(--validate-dataset-name on the evaluation CLI)")


def load_labels(cfg: Config) -> list[str]:
    """The class names of `cfg`'s dataset, from `cfg.data.labels_path`."""
    key = cfg.data.validate_dataset_name
    if key is None:   # hand-built / unresolved Config, or un-inferable family
        key = labels_key_for(cfg.data.dataset_name)
    with open(cfg.data.labels_path) as f:
        return json.load(f)[key]


def load_templates(cfg: Config) -> list[str]:
    """The prompt templates `cfg.data.template_key` of
    `cfg.data.templates_path`."""
    with open(cfg.data.templates_path) as f:
        return json.load(f)[cfg.data.template_key]


def _field_arg_type(f, default):
    """Argument parser of a dataclass field; None-default fields parse by
    their annotation."""
    if f.type in ("bool", bool) or isinstance(default, bool):
        return lambda s: s.lower() in ("1", "true", "yes")
    if default is not None:
        return type(default)
    ann = str(f.type)
    if "int" in ann:
        return int
    if "float" in ann:
        return float
    return str


def _add_fields(parser: argparse.ArgumentParser, prefix: str, dc) -> None:
    for f in dataclasses.fields(dc):
        arg = f"--{prefix}{f.name.replace('_', '-')}"
        default = getattr(dc, f.name)
        parser.add_argument(arg, type=_field_arg_type(f, default),
                            default=argparse.SUPPRESS)


def parse_args(argv=None) -> Config:
    """The evaluation CLI's flags, spelled as in the JAX package
    (`--eva-depth`, `--dota-mode-M`, `--cache-shot-capacity`, ...).
    Defaults, then the per-dataset cache table (`Config.resolve`), then
    explicit flags: an explicit cache flag beats the table."""
    cfg = Config()
    parser = argparse.ArgumentParser(
        description="Uni-Adapter on PyTorch/CUDA: online TTA for 3D VLMs")
    _add_fields(parser, "", cfg.run)
    _add_fields(parser, "", cfg.data)
    _add_fields(parser, "", cfg.model)
    _add_fields(parser, "dota-", cfg.dota)
    _add_fields(parser, "cache-", cfg.cache)
    ns = parser.parse_args(argv)

    def explicit(dc, prefix=""):
        return {f.name: getattr(ns, prefix + f.name)
                for f in dataclasses.fields(dc) if hasattr(ns, prefix + f.name)}

    cache_explicit = explicit(cfg.cache, "cache_")
    cfg = Config(
        model=dataclasses.replace(cfg.model, **explicit(cfg.model)),
        dota=dataclasses.replace(cfg.dota, **explicit(cfg.dota, "dota_")),
        cache=dataclasses.replace(cfg.cache, **cache_explicit),
        data=dataclasses.replace(cfg.data, **explicit(cfg.data)),
        run=dataclasses.replace(cfg.run, **explicit(cfg.run)),
    )
    if cfg.run.device not in ("cuda", "cpu"):
        raise ValueError(f"--device {cfg.run.device!r}: expected cuda or cpu")
    # the JAX parser's checks of --dist-mode, --trunk-parallel,
    # --vmap-corruptions and --continual
    r = cfg.run
    if r.dist_mode not in ("replicated", "sharded", "psum", "ep"):
        raise ValueError(f"--dist-mode {r.dist_mode!r}: expected "
                         "replicated, sharded, psum, or ep")
    if r.dist_mode == "ep":
        # every adaptation method class-shards (parallel/ep.py); only the
        # encoder-sharding lever is MODE-DOTA's
        if r.ep_shard_encoder and not cfg.dota.use_mode_dota:
            raise ValueError(
                "--ep-shard-encoder splits MODE-DOTA's fused 2-forward "
                "batch; the cache, plain-DOTA, GMM-DOTA, and adaptive "
                "paths run one forward per step — nothing to split")
    elif r.ep_shard_encoder:
        raise ValueError(
            "--ep-shard-encoder splits the fused encoder batch over the EP "
            "class axis; it has no effect unless --dist-mode ep")
    if r.trunk_parallel not in ("none", "tp", "pp", "sp"):
        raise ValueError(f"--trunk-parallel {r.trunk_parallel!r}: "
                         "expected none, tp, pp, or sp")
    if r.trunk_parallel != "none":
        if r.dist_mode != "replicated":
            raise ValueError(
                "--trunk-parallel shards the trunk over ALL devices; it "
                "cannot compose with --dist-mode stream sharding from the "
                "CLI (use the library API for 2-D meshes)")
        if r.vmap_corruptions:
            raise ValueError("--trunk-parallel does not compose with "
                             "--vmap-corruptions (vmap over the trunk's "
                             "shard_map); run corruptions sequentially")
    if r.continual:
        if r.vmap_corruptions:
            raise ValueError(
                "--continual carries one adaptation trajectory through the "
                "corruption SEQUENCE; --vmap-corruptions runs the streams "
                "in parallel — the two are mutually exclusive")
        if r.dist_mode not in ("replicated", "ep"):
            raise ValueError(
                "--continual requires --dist-mode replicated or ep from "
                "the CLI (sharded/psum modes change the adaptation order "
                "and re-build their mesh state per stream; chain them via "
                "the library API if needed)")
    cfg = cfg.resolve()
    return dataclasses.replace(
        cfg, cache=dataclasses.replace(cfg.cache, **cache_explicit))
