"""Config system, a copy of ``vqa_tpu/config.py`` (the port imports nothing
of the JAX package).

The same nested YAML schema (``options/vqa2/<model>.yaml`` over
``options/default.yaml``), the same override grammar (``key.sub=value``,
value parsed as YAML, or ``(key, value)`` tuples) and the same typed
:class:`Options` tree. ``yaml`` is imported where a file or an override is
parsed, not when the module is imported.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import typing
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union


# --------------------------------------------------------------------------
# dict plumbing
# --------------------------------------------------------------------------


def load_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path, "r") as f:
        data = yaml.safe_load(f)
    return data or {}


def deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``override`` into ``base`` (override wins)."""
    out = copy.deepcopy(base)
    for key, value in override.items():
        if key in out and isinstance(out[key], dict) and isinstance(value, dict):
            out[key] = deep_merge(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


def set_dotted(tree: Dict[str, Any], dotted_key: str, value: Any) -> None:
    """Set ``tree['a']['b']['c'] = value`` for dotted_key ``'a.b.c'``."""
    keys = dotted_key.split(".")
    node = tree
    for key in keys[:-1]:
        node = node.setdefault(key, {})
        if not isinstance(node, dict):
            raise TypeError(f"cannot descend into non-dict at {key!r} of {dotted_key!r}")
    node[keys[-1]] = value


def get_dotted(tree: Dict[str, Any], dotted_key: str, default: Any = None) -> Any:
    node: Any = tree
    for key in dotted_key.split("."):
        if not isinstance(node, dict) or key not in node:
            return default
        node = node[key]
    return node


def parse_override(spec: str) -> tuple:
    """Parse ``key.sub=value`` where value is interpreted as YAML.

    YAML 1.1 wordifies on/off/yes/no into booleans, which would launder
    documented string values like ``--opt engine.pallas=on`` into True;
    only literal true/false spellings stay boolean."""
    import yaml

    if "=" not in spec:
        raise ValueError(f"override {spec!r} must look like key.sub=value")
    key, _, raw = spec.partition("=")
    raw = raw.strip()
    value = yaml.safe_load(raw) if raw else None
    if isinstance(value, bool) and raw.lower() not in ("true", "false"):
        value = raw
    return key.strip(), value


# --------------------------------------------------------------------------
# typed options
# --------------------------------------------------------------------------


@dataclasses.dataclass
class LogsOptions:
    dir_logs: str = "logs/vqa2/default"


@dataclasses.dataclass
class VQAOptions:
    """Dataset options (SURVEY.md C3-C5 knobs)."""

    dataset: str = "VQA2"
    dir: str = "data/vqa2"
    trainsplit: str = "train"          # 'train' or 'trainval'
    nans: int = 2000                   # answer-vocab size
    maxlength: int = 26                # question pad length
    minwcount: int = 0                 # word min count for vocab
    nlp: str = "mcb"                   # tokenizer flavor
    pad: str = "right"                 # question padding side
    samplingans: bool = True           # sample answer by confidence vs most-frequent
    augment_dir: Optional[str] = None  # Visual-Genome-style QA augmentation (C24)


@dataclasses.dataclass
class CocoOptions:
    """Image-feature options (SURVEY.md C6)."""

    dir: str = "data/coco"
    arch: str = "bottomup36"           # 'bottomup36' (36x2048) or grid e.g. 'fbresnet152'
    mode: str = "att"                  # 'att' (region/grid) or 'noatt' (pooled vector)


@dataclasses.dataclass
class OptimOptions:
    lr: float = 1e-4
    batch_size: int = 128
    epochs: int = 20
    optimizer: str = "adam"            # 'adam' | 'sgd'
    momentum: float = 0.9
    weight_decay: float = 0.0
    lr_decay: Optional[float] = None   # multiplicative per-epoch decay
    grad_clip: Optional[float] = None
    eval_batch_size: Optional[int] = None
    # accumulate k micro-batch gradients (mean) per applied update — an
    # effective batch of k*batch_size without the HBM footprint. Changes
    # the opt_state tree: checkpoints don't resume across on/off.
    grad_accum: int = 1


@dataclasses.dataclass
class ModelOptions:
    """Model arch + per-arch sub-dicts.

    The arch-specific shapes differ per family (SURVEY.md C8-C14), so
    the subsections stay dicts validated by the model factory.
    """

    arch: str = "MutanAtt"
    seq2vec: Dict[str, Any] = dataclasses.field(default_factory=dict)
    attention: Dict[str, Any] = dataclasses.field(default_factory=dict)
    fusion: Dict[str, Any] = dataclasses.field(default_factory=dict)
    classif: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # npz of a full flattened param tree to graft over the init params
    # (e.g. a converted reference torch checkpoint: tools/import_torch.py
    # --kind model); leaves merge by path with shape validation
    pretrained_params: Optional[str] = None
    # family-specific extensions (MFB pooling, CoR chain) live here too
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class EngineOptions:
    print_freq: int = 10
    seed: int = 1337
    dtype: str = "float32"             # compute dtype: 'float32' | 'bfloat16'
    donate: bool = True
    profile_dir: Optional[str] = None  # jax.profiler trace dir (SURVEY.md section 5.1)
    nan_check: bool = False            # jax.debug_nans-style guard (section 5.2)
    pallas: str = "auto"               # 'auto' | 'on' | 'off' — fused-kernel layer
    # JAX PRNG implementation for dropout streams: 'rbg' (XLA RngBitGenerator,
    # measured +19% CoR train — mask generation is a real cost on dropout-
    # heavy models) or 'threefry2x32' (JAX default). Both deterministic per
    # seed; streams differ between the two.
    rng_impl: str = "rbg"
    # recurrence (LSTM/GRU) backward for the train step: 'bigmatmul' (hand-
    # written vjp — only dh-propagation stays sequential, both weight grads
    # become single full-rate GEMMs; measured +10% train throughput, grads
    # == native AD, see ops/lstm.py) or 'native' (XLA scan AD)
    rnn_bwd: str = "bigmatmul"
    device_features: bool = False      # HBM-resident feature table + on-device gather
    features_dtype: str = "float32"    # dtype for the device feature table
    # row-shard the device feature table over all mesh devices instead of
    # replicating (for tables bigger than one chip's HBM, e.g. trainval
    # bottom-up); the in-step gather becomes an XLA-partitioned collective
    features_sharded: bool = False
    model_parallel: int = 1            # mesh 'model'-axis size (TP seam, section 2.3)
    # mid-epoch preemption points: every N train steps, save a step
    # checkpoint (kept alongside the per-epoch saves; exactly one at a
    # time, superseded when its epoch completes). --resume latest restores
    # it and fast-forwards the deterministic pipeline to the exact batch,
    # bit-identical to an uninterrupted run (dropout folds state.step;
    # epoch order is a pure function of (seed, epoch)). 0 = off.
    # Cost: one flagship-dims save measured 2.4s warm / 170MB (r3s4), and
    # the save is synchronous — pick N worth minutes of compute (e.g.
    # N=5000 at ~50ms/step ≈ 1% overhead) rather than seconds.
    checkpoint_steps: int = 0
    # train-time bucketed shuffling: sort by length inside windows of
    # N*batch_size, shuffle batch order; cuts LSTM steps to ~mean length.
    # 0 = off (the reference's exact uniform shuffle)
    train_bucketing: int = 0
    # train-time question-length bucket ladder (right-pad only; active when
    # train_bucketing > 0). None -> {7, maxlength/2, maxlength}: VQA v2
    # questions average ~6 tokens, so ~3/4 of bucketed batches ride the
    # 7-rung (measured +~20% train blend over the {13,26} ladder). One
    # train-step compile per rung.
    train_buckets: Optional[List[int]] = None
    # eval-time question-length buckets (right-pad only). None -> the
    # default {maxlength/2, maxlength} ladder; real VQA questions average
    # ~6 tokens, so e.g. [7, 13, 26] shortens the LSTM scan further at the
    # cost of one extra compile per bucket
    eval_buckets: Optional[List[int]] = None


@dataclasses.dataclass
class Options:
    logs: LogsOptions
    vqa: VQAOptions
    coco: CocoOptions
    optim: OptimOptions
    model: ModelOptions
    engine: EngineOptions
    raw: Dict[str, Any]                # merged dict, for provenance dump

    @property
    def dir_logs(self) -> str:
        return self.logs.dir_logs


_SECTION_TYPES = {
    "logs": LogsOptions,
    "vqa": VQAOptions,
    "coco": CocoOptions,
    "optim": OptimOptions,
    "engine": EngineOptions,
}


def _coerce(section: str, name: str, ftype, value):
    """Coerce a YAML/CLI value to the dataclass field's declared type.

    Guards against the '--lr 1e-5' trap: YAML 1.1 parses bare-exponent floats
    as strings, and a string lr crashes deep inside optax. Coercion happens at
    config-build time with a clear error instead.
    """
    origin = typing.get_origin(ftype)
    if origin is Union:  # Optional[T]
        args = [a for a in typing.get_args(ftype) if a is not type(None)]
        if value is None:
            return None
        if len(args) != 1:
            return value
        ftype = args[0]
    where = f"{section}.{name}"
    if ftype is float:
        if isinstance(value, bool):
            raise TypeError(f"{where} expects a float, got bool {value!r}")
        if isinstance(value, (int, float)):
            return float(value)
        if isinstance(value, str):
            try:
                return float(value)
            except ValueError:
                raise TypeError(f"{where} expects a float, got {value!r}") from None
    elif ftype is int:
        if isinstance(value, bool):
            raise TypeError(f"{where} expects an int, got bool {value!r}")
        if isinstance(value, int):
            return value
        if isinstance(value, float) and value.is_integer():
            return int(value)
        if isinstance(value, str):
            try:
                return int(value)
            except ValueError:
                raise TypeError(f"{where} expects an int, got {value!r}") from None
    elif ftype is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, str) and value.lower() in ("true", "false"):
            return value.lower() == "true"
    elif ftype is str:
        if isinstance(value, str):
            return value
        if isinstance(value, bool):
            raise TypeError(
                f"{where} expects a string, got bool {value!r} (YAML parses "
                "on/off/yes/no as booleans; quote the value)"
            )
        if isinstance(value, (int, float)):
            return str(value)
    else:
        return value
    raise TypeError(f"{where} expects {ftype.__name__}, got {type(value).__name__} {value!r}")


def _build_section(cls, data: Dict[str, Any], section: Optional[str] = None):
    section = section or cls.__name__
    fields = {f.name: f for f in dataclasses.fields(cls)}
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for key, value in data.items():
        if key not in fields:
            raise KeyError(
                f"unknown option {key!r} for section {cls.__name__}; "
                f"known: {sorted(fields)}"
            )
        kwargs[key] = _coerce(section, key, hints[key], value)
    return cls(**kwargs)


def _build_model_section(data: Dict[str, Any]) -> ModelOptions:
    known = {"arch", "seq2vec", "attention", "fusion", "classif", "pretrained_params"}
    kwargs: Dict[str, Any] = {"extra": {}}
    for key, value in data.items():
        if key in known:
            kwargs[key] = value
        else:
            kwargs["extra"][key] = value
    return ModelOptions(**kwargs)


def options_from_dict(merged: Dict[str, Any]) -> Options:
    unknown = set(merged) - (set(_SECTION_TYPES) | {"model"})
    if unknown:
        raise KeyError(f"unknown top-level config sections: {sorted(unknown)}")
    sections = {
        name: _build_section(cls, merged.get(name, {}) or {}, name)
        for name, cls in _SECTION_TYPES.items()
    }
    model = _build_model_section(merged.get("model", {}) or {})
    return Options(model=model, raw=merged, **sections)


def load_options(
    path_opt: str,
    overrides: Optional[Sequence[Union[str, Tuple[str, Any]]]] = None,
    default_path: Optional[str] = None,
) -> Options:
    """default.yaml <- model yaml <- ``--opt`` overrides (left to right wins).

    Overrides are either ``"key.sub=value"`` strings (value parsed as YAML)
    or ``("key.sub", value)`` tuples carrying an already-typed value — named
    CLI flags use the tuple form to avoid the YAML round-trip (a float like
    1e-05 is not valid YAML 1.1 and would come back as a string).
    """
    if default_path is None:
        candidate = os.path.join(os.path.dirname(os.path.dirname(path_opt)), "default.yaml")
        default_path = candidate if os.path.exists(candidate) else None
    merged: Dict[str, Any] = load_yaml(default_path) if default_path else {}
    merged = deep_merge(merged, load_yaml(path_opt))
    for spec in overrides or []:
        key, value = spec if isinstance(spec, tuple) else parse_override(spec)
        set_dotted(merged, key, value)
    return options_from_dict(merged)


COMPUTE_DTYPES = ("float32", "bfloat16")  # engine.dtype's values


def compute_dtype(opt: Options):
    """The torch dtype the model computes in: ``engine.dtype`` on every
    device, as the JAX CLI, Predictor and export take it. Every kernel of
    the models has a float32 and a bf16 entry on the card, so the card
    computes what the config names, as the host does."""
    import torch

    name = opt.engine.dtype
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"engine.dtype must be one of {COMPUTE_DTYPES}, got {name!r}")
    return getattr(torch, name)


def dump_options(opt: Options, run_dir: str, name: str = "options.yaml") -> str:
    """Write the merged config into the run dir for provenance (SURVEY.md 5.6)."""
    import yaml

    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, name)
    with open(path, "w") as f:
        yaml.safe_dump(opt.raw, f, sort_keys=False)
    return path
