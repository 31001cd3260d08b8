"""Typed configuration system for gaot_torch (the same schema as the JAX
package, so both read the same config files).

Mirrors the reference's dataclass-default + user-override merge semantics
(reference: src/core/default_configs.py:15-97, src/model/layers/magno.py:26-69,
src/model/layers/attn.py:19-38, src/utils/optimizers.py:12-29) without the
OmegaConf dependency: a small recursive merger constructs typed dataclasses
from JSON/TOML dicts and rejects unknown keys.
"""
from __future__ import annotations

import dataclasses
import json
import types
import typing
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# Merge machinery
# ---------------------------------------------------------------------------

class ConfigError(ValueError):
    pass


def _is_optional(tp) -> Tuple[bool, Any]:
    """Return (is_optional, inner_type) for Optional[T] annotations."""
    origin = typing.get_origin(tp)
    if origin is typing.Union or origin is types.UnionType:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return True, args[0]
    return False, tp


def _coerce(value: Any, tp: Any, path: str) -> Any:
    """Coerce a raw (JSON/TOML) value to the annotated type."""
    if tp is Any or tp is None:
        return value
    is_opt, tp = _is_optional(tp)
    if value is None:
        if is_opt:
            return None
        raise ConfigError(f"{path}: null not allowed for type {tp}")

    origin = typing.get_origin(tp)
    if dataclasses.is_dataclass(tp):
        return merge_config(tp, value, _path=path)
    if origin in (list, List, Sequence, typing.Sequence):
        (item_tp,) = typing.get_args(tp) or (Any,)
        return [_coerce(v, item_tp, f"{path}[{i}]") for i, v in enumerate(value)]
    if origin in (tuple, Tuple):
        args = typing.get_args(tp)
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_coerce(v, args[0], f"{path}[{i}]") for i, v in enumerate(value))
        if args and len(args) != len(value):
            # Allow length-flexible tuples (e.g. latent_tokens_size 2D vs 3D).
            return tuple(_coerce(v, args[0], f"{path}[{i}]") for i, v in enumerate(value))
        return tuple(
            _coerce(v, a, f"{path}[{i}]") for i, (v, a) in enumerate(zip(value, args or []))
        ) if args else tuple(value)
    if origin in (dict,):
        return dict(value)
    if tp is float and isinstance(value, (int, float)):
        return float(value)
    if tp is int:
        if isinstance(value, bool):
            raise ConfigError(f"{path}: expected int, got bool")
        if isinstance(value, float) and value.is_integer():
            return int(value)
        if isinstance(value, int):
            return value
        raise ConfigError(f"{path}: expected int, got {type(value).__name__}")
    if tp is bool and not isinstance(value, bool):
        raise ConfigError(f"{path}: expected bool, got {type(value).__name__}")
    if tp is str and not isinstance(value, str):
        raise ConfigError(f"{path}: expected str, got {type(value).__name__}")
    return value


def merge_config(default_config_class, user_config, _path: str = ""):
    """Merge a user config (dict or dataclass instance) over dataclass defaults.

    Equivalent in role to the reference's ``merge_config``
    (src/core/default_configs.py:15-19): unknown keys raise, nested dataclasses
    merge recursively, and the result is a plain typed dataclass instance.
    """
    if user_config is None:
        user_config = {}
    if dataclasses.is_dataclass(user_config) and not isinstance(user_config, type):
        user_config = dataclasses.asdict(user_config)
    if not isinstance(user_config, dict):
        raise ConfigError(f"{_path or default_config_class.__name__}: expected a mapping")

    fields = {f.name: f for f in dataclasses.fields(default_config_class)}
    hints = typing.get_type_hints(default_config_class)
    kwargs = {}
    for key, raw in user_config.items():
        if key not in fields:
            raise ConfigError(
                f"Unknown config key '{_path + '.' if _path else ''}{key}' "
                f"for {default_config_class.__name__}"
            )
        kwargs[key] = _coerce(raw, hints[fields[key].name], f"{_path}.{key}" if _path else key)
    return default_config_class(**kwargs)


def load_config_file(path: str) -> dict:
    """Load a JSON or TOML config file into a plain dict.

    Mirrors the reference CLI's FileParser (main.py:19-42).
    """
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    if path.endswith(".toml"):
        import tomllib

        with open(path, "rb") as f:
            return tomllib.load(f)
    raise ConfigError(f"Unsupported config file type: {path} (use .json or .toml)")


# ---------------------------------------------------------------------------
# Model component configs
# ---------------------------------------------------------------------------

@dataclass
class MAGNOConfig:
    """MAGNO encoder/decoder configuration (reference src/model/layers/magno.py:26-69)."""

    # Core
    coord_dim: int = 2                  # Coordinate dimension (2 or 3)
    radius: float = 0.033               # Radius for neighbor search
    hidden_size: int = 64               # Base hidden size for all MLPs
    mlp_layers: int = 3                 # Number of hidden MLP layers
    lifting_channels: int = 32          # Channels after the encoder lifting

    # Multi-scale
    scales: List[float] = field(default_factory=lambda: [1.0])
    use_scale_weights: bool = False     # Learnable per-query scale weights

    # Attention & embedding
    use_attention: bool = True
    attention_type: str = "cosine"      # ['cosine', 'dot_product']
    use_geoembed: bool = True
    embedding_method: str = "statistical"  # ['statistical', 'pointnet']
    pooling: str = "max"                # pooling for pointnet ['max','mean','sum']

    # Transform & sampling
    transform_type: str = "linear"      # ['linear','nonlinear','linear_kernelonly','nonlinear_kernelonly']
    sampling_strategy: Optional[str] = None  # ['max_neighbors', 'ratio', None]
    max_neighbors: Optional[int] = None
    sample_ratio: Optional[float] = None

    # Advanced
    node_embedding: bool = False        # Fourier positional node embedding
    neighbor_search_method: str = "auto"  # ['auto','cpp','kdtree','grid']
    neighbor_strategy: str = "radius"   # ['radius', 'knn']
    precompute_edges: bool = False
    # Padding controls (no reference equivalent — the reference keeps
    # ragged CSR, this package pads to a static K per scale).
    neighbor_pad_multiple: int = 8      # round padded K up to a multiple of this
    neighbor_cap: Optional[int] = None  # hard cap on padded K (truncates graphs)
    use_transpose_backward: bool = True  # build transpose graphs for the
                                         # scatter-free backward
    morton_ordering: bool = True         # Morton (Z-order) sort vx nodes at
                                         # graph build so per-edge row
                                         # gathers hit locally-dense HBM
                                         # rows instead of random ones
                                         # (ops/padding.py::morton_order;
                                         # loaders reorder u/c to match).
                                         # Data-layout change only: losses,
                                         # metrics and plots see the same
                                         # (coord, value) pairs.
    use_query_bucketing: bool = True     # re-pack graphs into degree buckets
                                         # (fx: ops/padding.py::bucketize_graph;
                                         # vx: bucketize_graphs_stacked with a
                                         # split-shared layout) — radius-graph
                                         # degrees are heavy-tailed, so
                                         # bucketing cuts padded gather
                                         # traffic and per-edge MLP FLOPs
                                         # with identical per-query math.

    def __post_init__(self):
        if self.coord_dim not in (2, 3):
            raise ConfigError(f"coord_dim must be 2 or 3, got {self.coord_dim}")
        if self.sampling_strategy == "ratio" and (
            self.sample_ratio is None or not 0 < self.sample_ratio <= 1
        ):
            raise ConfigError("sample_ratio must be in (0, 1] when using 'ratio' sampling")
        if self.sampling_strategy == "max_neighbors" and (
            self.max_neighbors is None or self.max_neighbors <= 0
        ):
            raise ConfigError("max_neighbors must be > 0 when using 'max_neighbors' sampling")
        if self.transform_type not in (
            "linear", "nonlinear", "linear_kernelonly", "nonlinear_kernelonly"
        ):
            raise ConfigError(f"Invalid transform_type: {self.transform_type}")


@dataclass
class AttentionConfig:
    """Attention sub-module config (reference src/model/layers/attn.py:19-25)."""

    num_heads: int = 8
    num_kv_heads: int = 8               # GQA: KV heads
    use_conditional_norm: bool = False  # time-conditional normalization
    cond_norm_hidden_size: int = 4
    atten_dropout: float = 0.0


@dataclass
class TransformerConfig:
    """ViT processor config (reference src/model/layers/attn.py:27-38)."""

    patch_size: int = 8
    hidden_size: int = 256
    use_attn_norm: bool = True
    use_ffn_norm: bool = True
    norm_eps: float = 1e-6
    num_layers: int = 3
    positional_embedding: str = "absolute"  # ['absolute', 'rope']
    use_long_range_skip: bool = True        # UViT long-range skips
    ffn_multiplier: int = 4
    attn_config: AttentionConfig = field(default_factory=AttentionConfig)
    attn_backend: str = "auto"              # ['auto', 'xla', 'pallas']:
                                            # 'auto' and 'pallas' take the flash
                                            # kernel's wrapper
                                            # (ops/cuda/flash_attention.py),
                                            # 'xla' the plain attention
    fused_ffn: str = "auto"                 # the fused SwiGLU kernel's wrapper
                                            # (ops/cuda/fused_ffn.py) at the
                                            # widths the JAX gate takes:
                                            # 'auto' (bf16 compute), 'on' (any
                                            # dtype), 'off' (the plain three
                                            # products)

    def __post_init__(self):
        if self.fused_ffn not in ("auto", "on", "off"):
            raise ConfigError(
                f"fused_ffn must be auto/on/off, got {self.fused_ffn!r}")
        if self.attn_backend not in ("auto", "xla", "pallas"):
            raise ConfigError(
                f"attn_backend must be auto/xla/pallas, got {self.attn_backend!r}")


# ---------------------------------------------------------------------------
# Top-level configs
# ---------------------------------------------------------------------------

@dataclass
class SetUpConfig:
    """Runtime setup (reference src/core/default_configs.py:22-38)."""

    seed: int = 42
    device: str = "auto"                # 'auto' | 'cuda' | 'cpu'
    dtype: str = "float32"              # parameters (the port keeps them fp32)
    compute_dtype: str = "float32"      # activation dtype inside matmuls ('bfloat16' to
                                        # run on the tensor cores; params stay in `dtype`)
    trainer_name: str = "static"        # ['static', 'sequential']
    train: bool = True
    test: bool = False
    ckpt: bool = False

    # Distributed / parallelism settings (gaot_torch/parallel/): one process
    # a rank, launched by torchrun; data_parallel x model_parallel must equal
    # the world size.
    distributed: bool = False           # join the process group (torch.distributed)
    data_parallel: int = -1             # -1: world size // model_parallel on the 'data' axis
    model_parallel: int = 1             # 'model' axis size (tensor parallel transformer)
    spatial_parallel: bool = False      # shard latent tokens / query points over 'model'
    #   (sequence parallelism for GAOT-3D-scale grids, fx data; see parallel/spatial.py)
    epoch_scan: str = "auto"            # the JAX package's whole-epoch scan; the
    #   port issues its steps one by one whatever it says (kept so both
    #   packages read the same configs)
    coordinator_address: Optional[str] = None   # rendezvous (host:port or URL);
    num_processes: Optional[int] = None         # else torchrun's environment
    process_id: Optional[int] = None
    profile_dir: Optional[str] = None   # if set, fit runs under torch.profiler and
    #   writes a Chrome trace (trace.json) here

    def __post_init__(self):
        if self.trainer_name not in ("static", "sequential"):
            raise ValueError(
                f"trainer_name must be 'static' or 'sequential', "
                f"got {self.trainer_name!r}")
        if str(self.epoch_scan).lower() not in (
                "auto", "always", "never", "true", "false"):
            raise ValueError(
                f"epoch_scan must be auto/always/never, got {self.epoch_scan!r}")


@dataclass
class ModelArgsConfig:
    magno: MAGNOConfig = field(default_factory=MAGNOConfig)
    transformer: TransformerConfig = field(default_factory=TransformerConfig)


@dataclass
class ModelConfig:
    """Model config (reference src/core/default_configs.py:48-54)."""

    name: str = "gaot"
    use_conditional_norm: bool = False
    latent_tokens_size: Tuple[int, ...] = (64, 64)
    args: ModelArgsConfig = field(default_factory=ModelArgsConfig)


@dataclass
class DatasetConfig:
    """Dataset config (reference src/core/default_configs.py:57-81)."""

    name: str = "CE-Gauss"
    metaname: str = "compressible_flow/CE-Gauss"
    base_path: str = "./data/"
    train_size: int = 1024
    val_size: int = 128
    test_size: int = 256
    coord_scaling: str = "per_dim_scaling"  # ['global_scaling', 'per_dim_scaling']
    batch_size: int = 64
    # Put the split arrays on the device once and gather each batch there
    # by index (the reference ships every batch host->device,
    # src/trainer/static_trainer.py:167-170). Above
    # data/loader.py::DEVICE_DATA_BYTE_LIMIT, and when false, batches are
    # assembled on the host and copied from pinned memory.
    device_data: bool = True
    # On-disk npz cache for precomputed vx graphs (reference
    # CachedGraphBuilder, src/datasets/graph_builder.py:177-285); read by
    # both trainers on vx data (data/graph_builder.py::
    # GraphBuilder.build_all_vx_graphs_cached), in the JAX package's format.
    graph_cache_dir: Optional[str] = None
    num_workers: int = 0                # kept for config-compat; loading is in-process
    shuffle: bool = True
    use_metadata_stats: bool = False
    sample_rate: float = 0.1
    use_sparse: bool = False
    rand_dataset: bool = False

    # Time-dependent parameters
    max_time_diff: int = 14
    time_step: int = 2
    use_time_norm: bool = True
    metric: str = "final_step"          # ['final_step', 'all_step']
    predict_mode: str = "all"           # ['all','autoregressive','direct','star']
    stepper_mode: str = "output"        # ['output','residual','time_der']


@dataclass
class OptimizerArgsConfig:
    """Optimizer args (reference src/utils/optimizers.py:12-29)."""

    lr: float = 1e-3
    weight_decay: float = 1e-3
    epoch: int = 100
    loss_scale: float = 1.0
    eval_every_eps: int = 2
    scheduler: str = "mix"              # ['step','cos','exp','mix','none']
    early_save_metric: str = "val"      # ['train','val']
    # mix scheduler
    max_lr: float = 1e-2
    min_lr: float = 1e-5
    final_lr: float = 1e-5
    # step scheduler
    scheduler_step_size: int = 100
    scheduler_gamma: float = 0.8
    scheduler_T_max: int = 100
    scheduler_eta_min: float = 1e-4


@dataclass
class OptimizerConfig:
    name: str = "adamw"                 # ['adamw', 'adam']
    args: OptimizerArgsConfig = field(default_factory=OptimizerArgsConfig)


@dataclass
class PathConfig:
    """Output paths (reference src/core/default_configs.py:92-97)."""

    ckpt_path: str = ".ckpt/test/test"
    loss_path: str = ".loss/test/test.png"
    result_path: str = ".result/test/test.png"
    database_path: str = ".database/test/test.csv"


@dataclass
class GAOTConfig:
    """Full experiment config (one training/eval job)."""

    setup: SetUpConfig = field(default_factory=SetUpConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    path: PathConfig = field(default_factory=PathConfig)


def load_experiment_config(path: str) -> GAOTConfig:
    """Load and validate a full experiment config from a JSON/TOML file."""
    return merge_config(GAOTConfig, load_config_file(path))
