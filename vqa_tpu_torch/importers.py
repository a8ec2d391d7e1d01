"""Torch-weight importers, a copy of ``vqa_tpu/importers.py`` (the port
imports nothing of the JAX package).

The reference lineage's pretrained assets are PyTorch state_dicts:
torchvision ImageNet ResNets for the grid extractor, the torch skip-thoughts
port for the question encoder, and full trained VQA checkpoints
(``torch.save`` payloads). These converters turn each into the '/'-keyed
flax trees the port reads (``weights.py``, ``models/convnets.py``), byte
for byte the trees the JAX package's converters give, so an npz written by
either tool loads in either package.

Everything here is numpy-in / numpy-out; the CLI
(``python -m vqa_tpu_torch.tools.import_torch``) does the
``torch.load(map_location='cpu')`` and hands in a flat ``{key: ndarray}``
dict. ``model_template`` takes the place of flax's ``model.init``: the
nested tree of a port model's parameters. Layout contracts (held against
torch modules by tests/test_torch_importers.py):

  torch Linear      weight [out, in], bias [out]   -> Dense  kernel [in, out]
  torch Embedding   weight [V, E]                  -> Embed  embedding [V, E]
  torch LSTM        weight_ih/hh [4H, *], gate order i,f,g,o (ours too)
                                                   -> wx/wh transposed,
                    b = b_ih + b_hh (one bias per gate in the scan cell)
  torch GRU         gate order r,z,n; b_ih/b_hh stay separate (the "n" gate
                    applies r *inside* the hidden bias term) -> bx, bh
  torch Conv2d      weight [O, I, kh, kw]          -> Conv kernel [kh, kw, I, O]
  torch BatchNorm2d weight/bias + running_mean/var -> params {scale, bias}
                                                      + batch_stats {mean, var}
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

Array = np.ndarray
Tree = Dict[str, Any]


# ---------------------------------------------------------------- layer level


def from_dense(weight: Array, bias: Optional[Array] = None) -> Tree:
    out = {"kernel": np.ascontiguousarray(weight.T)}
    if bias is not None:
        out["bias"] = np.asarray(bias)
    return out


def from_embedding(weight: Array) -> Tree:
    return {"embedding": np.asarray(weight)}


def from_lstm(w_ih: Array, w_hh: Array, b_ih: Array, b_hh: Array) -> Tree:
    """torch LSTM layer -> LSTMLayer {wx, wh, b} (models/seq2vec.py)."""
    return {
        "wx": np.ascontiguousarray(w_ih.T),
        "wh": np.ascontiguousarray(w_hh.T),
        "b": np.asarray(b_ih) + np.asarray(b_hh),
    }


def from_gru(w_ih: Array, w_hh: Array, b_ih: Array, b_hh: Array) -> Tree:
    """torch GRU layer -> GRULayer {wx, wh, bx, bh} (biases must stay split)."""
    return {
        "wx": np.ascontiguousarray(w_ih.T),
        "wh": np.ascontiguousarray(w_hh.T),
        "bx": np.asarray(b_ih),
        "bh": np.asarray(b_hh),
    }


def from_conv(weight: Array, bias: Optional[Array] = None) -> Tree:
    out = {"kernel": np.ascontiguousarray(weight.transpose(2, 3, 1, 0))}
    if bias is not None:
        out["bias"] = np.asarray(bias)
    return out


def from_batchnorm(sd: Mapping[str, Array], prefix: str) -> Tuple[Tree, Tree]:
    """``{prefix}.{weight,bias,running_mean,running_var}`` ->
    (params {scale, bias}, batch_stats {mean, var})."""
    return (
        {"scale": np.asarray(sd[f"{prefix}.weight"]),
         "bias": np.asarray(sd[f"{prefix}.bias"])},
        {"mean": np.asarray(sd[f"{prefix}.running_mean"]),
         "var": np.asarray(sd[f"{prefix}.running_var"])},
    )


# ------------------------------------------------------------- state_dict I/O


def strip_prefixes(sd: Mapping[str, Array]) -> Dict[str, Array]:
    """Unwrap ``nn.DataParallel`` ('module.') — the lineage saves through it."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def _require(sd: Mapping[str, Array], key: str) -> Array:
    if key not in sd:
        near = sorted(k for k in sd if key.split(".")[0] in k)[:6]
        raise KeyError(f"state_dict has no {key!r}; nearby keys: {near}")
    return np.asarray(sd[key])


# ----------------------------------------------------------- ResNet (C15)


def resnet_from_torch(
    sd: Mapping[str, Array], stage_sizes: Sequence[int]
) -> Tree:
    """torchvision ResNet state_dict -> models/convnets.ResNet variables
    {'params': ..., 'batch_stats': ...} (the ``cli/extract.py --params``
    tree).

    torchvision names: conv1/bn1 stem; layer{1..4}.{b}.conv{1..3}/bn{1..3};
    layer{s}.{b}.downsample.{0 conv, 1 bn}. The classifier ``fc.*`` is
    dropped — the extractor stops at the conv5 grid (SURVEY call stack 3.5).
    """
    sd = strip_prefixes(sd)
    params: Tree = {}
    stats: Tree = {}

    params["stem"] = from_conv(_require(sd, "conv1.weight"))
    params["bn_stem"], stats["bn_stem"] = from_batchnorm(sd, "bn1")

    for stage, n_blocks in enumerate(stage_sizes):
        for block in range(n_blocks):
            t = f"layer{stage + 1}.{block}"
            ours = f"s{stage}_b{block}"
            p: Tree = {}
            s: Tree = {}
            for i in (1, 2, 3):
                p[f"conv{i}"] = from_conv(_require(sd, f"{t}.conv{i}.weight"))
                p[f"bn{i}"], s[f"bn{i}"] = from_batchnorm(sd, f"{t}.bn{i}")
            if f"{t}.downsample.0.weight" in sd:
                p["proj"] = from_conv(_require(sd, f"{t}.downsample.0.weight"))
                p["bn_proj"], s["bn_proj"] = from_batchnorm(sd, f"{t}.downsample.1")
            params[ours] = p
            stats[ours] = s
    return {"params": params, "batch_stats": stats}


# ------------------------------------------- question encoder (C8) importers


def seq_encoder_from_torch(
    sd: Mapping[str, Array],
    cell: str,
    num_layers: int = 1,
    embedding_key: str = "embedding.weight",
    rnn_prefix: str = "rnn",
) -> Tree:
    """torch ``Embedding + nn.LSTM/nn.GRU`` state_dict -> SeqEncoder params.

    Defaults match the lineage's torch skip-thoughts port layout
    (``embedding.weight`` + ``rnn.weight_ih_l0`` ...); override
    ``embedding_key``/``rnn_prefix`` for other checkpoints.
    """
    sd = strip_prefixes(sd)
    conv = {"lstm": from_lstm, "gru": from_gru}[cell]
    params: Tree = {"embed": from_embedding(_require(sd, embedding_key))}
    for layer in range(num_layers):
        args = tuple(
            _require(sd, f"{rnn_prefix}.{name}_l{layer}")
            for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
        )
        params[f"{cell}_{layer}"] = conv(*args)
    return params


def align_embedding_to_vocab(
    table: Array,
    source_words: Sequence[str],
    target_words: Sequence[str],
    oov: str = "zeros",
) -> Tuple[Array, int]:
    """Re-index a pretrained embedding table onto OUR word vocab (the
    ``pretrained_emb`` graft, weights.pretrained_params): row i of the
    result is the source row for target_words[i]. ``target_words`` is the run's
    ``wid_to_word`` list from vocab.json ([0]=<pad>, [1]=<unk> —
    datasets/processed.py). Row 0 stays zero (SeqEncoder masks on
    token!=0); missing words (incl. <unk>) get the ``oov`` fill:
    'zeros' | 'mean' (mean of matched rows, the skip-thoughts convention).
    Returns (aligned table, n_oov)."""
    index = {w: i for i, w in enumerate(source_words)}
    dim = table.shape[1]
    rows = np.zeros((len(target_words), dim), table.dtype)
    hits = [index[w] for w in target_words[1:] if w in index]
    fill = table[hits].mean(axis=0) if (oov == "mean" and hits) else np.zeros(dim, table.dtype)
    n_oov = 0
    for i, w in enumerate(target_words):
        if i == 0:
            continue  # <pad>
        j = index.get(w)
        if j is None:
            rows[i] = fill
            n_oov += 1
        else:
            rows[i] = table[j]
    return rows, n_oov


def skipthoughts_from_theano(npz: Mapping[str, Array]) -> Tree:
    """The PUBLISHED skip-thoughts weights (Kiros et al.'s ``uni_skip.npz``,
    theano layout) -> SeqEncoder GRU params (C8's pretrained path).

    The original gru_layer packs the r,z gates in ``encoder_W/U/b`` (slice 0
    = r, slice 1 = z/u) and the candidate in ``encoder_Wx/Ux/bx``; the
    candidate applies r AFTER the hidden matmul (tanh(xx + r*(h@Ux))) with
    no hidden-side bias, and the carry mixes as u*h + (1-u)*n — exactly our
    GRULayer with wx=[W|Wx], wh=[U|Ux], bx=[b|bx], bh=0 (torch r,z,n order).
    Theano stores weights [in, out], so no transpose.

    The ``Wemb`` training-vocab embedding is intentionally NOT emitted: runs
    use the expanded utable/btable + dictionary.txt via
    ``python -m vqa_tpu_torch.tools.import_torch --kind embedding`` (vocab
    re-alignment).
    """
    W, U, b = (_require(npz, f"encoder_{k}") for k in ("W", "U", "b"))
    Wx, Ux, bx = (_require(npz, f"encoder_{k}") for k in ("Wx", "Ux", "bx"))
    H = Ux.shape[0]
    if W.shape[1] != 2 * H or U.shape[0] != H:
        raise ValueError(
            f"inconsistent skip-thoughts dims: W {W.shape}, U {U.shape}, Ux {Ux.shape}"
        )
    return {
        "gru_0": {
            "wx": np.concatenate([W, Wx], axis=1),
            "wh": np.concatenate([U, Ux], axis=1),
            "bx": np.concatenate([b, bx]),
            "bh": np.zeros(3 * H, b.dtype),
        }
    }


# -------------------------------------------- full-model (C20 payload) import
#
# The reference lineage checkpoints whole models with ``torch.save`` (SURVEY
# C20). A migration spec maps OUR param-tree paths to the torch state_dict's
# module names; converters below cover every layer shape the lineage uses,
# including its ModuleList idioms:
#
#   rank_dense      ModuleList of R Linears [in -> M]   (the MUTAN Tucker
#                   core's per-rank projections) -> one kernel [in, R*M] +
#                   bias [R*M] — exactly our w_core_*/b_core_* layout
#   blockdiag_dense ModuleList of per-glimpse Linears [in_g -> out_g] (the
#                   lineage projects each attention glimpse separately, then
#                   concatenates) -> one block-diagonal kernel
#                   [sum in_g, sum out_g] — functionally identical inside our
#                   single fused Dense
#
# Spec entries: {"path": "our/param/path", "kind": <converter>,
#                "key": "torch.module.name", ["leaves": [...]], ["layer": k]}
# Every import is shape-validated leaf-by-leaf against a template tree
# (``model_template``) — a wrong or renamed torch key fails loudly, never
# silently.


def _conv1x1_dense(sd: Mapping[str, Array], key: str) -> Tree:
    """torch Conv2d(ci, co, 1) used as a per-position Linear -> Dense."""
    w = _require(sd, f"{key}.weight")  # [O, I, 1, 1]
    if w.ndim != 4 or w.shape[2] != 1 or w.shape[3] != 1:
        raise ValueError(f"{key}.weight is {w.shape}, expected a 1x1 conv")
    out = {"kernel": np.ascontiguousarray(w[:, :, 0, 0].T)}
    if f"{key}.bias" in sd:
        out["bias"] = np.asarray(sd[f"{key}.bias"])
    return out


def _module_list_indices(sd: Mapping[str, Array], key: str) -> list:
    idx = []
    while f"{key}.{len(idx)}.weight" in sd:
        idx.append(len(idx))
    if not idx:
        raise KeyError(f"no ModuleList entries under {key!r} (missing {key}.0.weight)")
    return idx


def _rank_dense(sd: Mapping[str, Array], key: str) -> Tree:
    ws, bs = [], []
    for r in _module_list_indices(sd, key):
        ws.append(np.asarray(sd[f"{key}.{r}.weight"]).T)  # [in, M]
        if f"{key}.{r}.bias" in sd:
            bs.append(np.asarray(sd[f"{key}.{r}.bias"]))
    if len(bs) not in (0, len(ws)):
        # a strict subset would misalign rank-to-slice silently when widths
        # happen to sum right; make the all-or-none invariant explicit
        raise ValueError(
            f"{key}: {len(bs)} of {len(ws)} rank Linears have biases "
            "(must be all or none)"
        )
    out = {"kernel": np.concatenate(ws, axis=1)}
    if bs:
        out["bias"] = np.concatenate(bs)
    return out


def _blockdiag_dense(sd: Mapping[str, Array], key: str) -> Tree:
    ws = [np.asarray(sd[f"{key}.{g}.weight"]).T for g in _module_list_indices(sd, key)]
    n_in, n_out = sum(w.shape[0] for w in ws), sum(w.shape[1] for w in ws)
    kernel = np.zeros((n_in, n_out), ws[0].dtype)
    i = j = 0
    bs = []
    for g, w in enumerate(ws):
        kernel[i : i + w.shape[0], j : j + w.shape[1]] = w
        i, j = i + w.shape[0], j + w.shape[1]
        if f"{key}.{g}.bias" in sd:
            bs.append(np.asarray(sd[f"{key}.{g}.bias"]))
    if len(bs) not in (0, len(ws)):
        raise ValueError(
            f"{key}: {len(bs)} of {len(ws)} glimpse Linears have biases "
            "(must be all or none)"
        )
    out = {"kernel": kernel}
    if bs:
        out["bias"] = np.concatenate(bs)
    return out


def _dense_entry(sd: Mapping[str, Array], key: str) -> Tree:
    return from_dense(
        _require(sd, f"{key}.weight"),
        np.asarray(sd[f"{key}.bias"]) if f"{key}.bias" in sd else None,
    )


def _rnn_entry(conv, sd: Mapping[str, Array], key: str, layer: int) -> Tree:
    return conv(*(
        _require(sd, f"{key}.{name}_l{layer}")
        for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
    ))


_ENTRY_KINDS = {
    "dense": _dense_entry,
    "conv1x1": _conv1x1_dense,
    "rank_dense": _rank_dense,
    "blockdiag_dense": _blockdiag_dense,
    "embedding": lambda sd, key: from_embedding(_require(sd, f"{key}.weight")),
    "lstm": lambda sd, key, layer=0: _rnn_entry(from_lstm, sd, key, layer),
    "gru": lambda sd, key, layer=0: _rnn_entry(from_gru, sd, key, layer),
}


def model_from_torch(
    sd: Mapping[str, Array],
    template: Tree,
    spec: Sequence[Mapping[str, Any]],
) -> Tuple[Tree, Dict[str, list]]:
    """Convert a full torch state_dict into a params tree shaped like
    ``template`` (from ``model_template``). Returns (tree, report) where report
    lists 'filled' and 'unfilled' leaf paths — callers decide whether
    unfilled leaves are an error (the CLI does, unless --allow_unfilled)."""
    sd = strip_prefixes(sd)
    tree = tree_copy(template)
    filled: list = []
    for entry in spec:
        kind = entry["kind"]
        fn = _ENTRY_KINDS.get(kind)
        if fn is None:
            raise KeyError(f"unknown spec kind {kind!r}; known: {sorted(_ENTRY_KINDS)}")
        kwargs = {"layer": entry["layer"]} if "layer" in entry else {}
        converted = fn(sd, entry["key"], **kwargs)
        if "pool_perm" in entry:
            # MFB pre-pool projections: the torch lineage sum-pools CONTIGUOUS
            # k-windows (AvgPool1d(k) * k) while our mfb_pool uses STRIDED
            # groups (group d sums z[..., j*m + d], a Mosaic-friendly
            # reparametrization — ops/mfb_pool.py). The two layouts differ by
            # a permutation of the projection's output channels, proven in
            # tests/test_fusion_torch_oracle.py::_strided_to_contiguous_perm;
            # apply its inverse here so imported weights feed our pool.
            k = int(entry["pool_perm"])
            out_dim = converted["kernel"].shape[-1]
            if out_dim % k:
                raise ValueError(
                    f"{entry['key']}: pool_perm k={k} does not divide the "
                    f"projection width {out_dim}"
                )
            m = out_dim // k
            o = np.arange(out_dim)
            inv = (o % m) * k + o // m  # ours[o] = torch[(o%m)*k + o//m]
            converted = {
                name: arr[..., inv] for name, arr in converted.items()
            }
        if "leaves" in entry:  # remap {kernel, bias} onto custom leaf names
            names = list(entry["leaves"])
            converted = dict(zip(names, [converted["kernel"], converted.get("bias")][: len(names)]))
            if any(v is None for v in converted.values()):
                raise KeyError(f"{entry['key']}: spec wants leaves {names} but "
                               "the torch module has no bias")
        path = entry["path"].split("/") if entry["path"] else []
        node = tree
        for part in path:
            if part not in node:
                raise KeyError(
                    f"spec path {entry['path']!r} not in the param tree; "
                    f"siblings here: {sorted(node)}"
                )
            node = node[part]
        for leaf, value in converted.items():
            if leaf not in node:
                raise KeyError(f"{entry['path']}/{leaf} not in the param tree; "
                               f"have: {sorted(node)}")
            want = tuple(np.shape(node[leaf]))
            got = tuple(value.shape)
            if want != got:
                raise ValueError(
                    f"{entry['path']}/{leaf}: torch {entry['key']} gives shape "
                    f"{got}, model expects {want} — check the spec/config dims"
                )
            node[leaf] = value.astype(np.asarray(node[leaf]).dtype)
            filled.append("/".join(path + [leaf]))
    unfilled = sorted(set(flatten_tree(tree)) - set(filled))
    return tree, {"filled": sorted(filled), "unfilled": unfilled}


def tree_copy(tree: Tree) -> Tree:
    """Deep-copy the dict structure, converting leaves to numpy."""
    if isinstance(tree, Mapping):
        return {k: tree_copy(v) for k, v in tree.items()}
    return np.asarray(tree)


# --------------------------------------------------------------- npz helpers


def flatten_tree(tree: Tree, sep: str = "/") -> Dict[str, Array]:
    flat: Dict[str, Array] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + (str(k),))
        else:
            flat[sep.join(path)] = np.asarray(node)

    walk(tree, ())
    return flat


def save_tree_npz(path: str, tree: Tree) -> None:
    """Write the '/'-flattened npz that ``cli/extract.py --params`` and the
    ``pretrained_emb``/params grafts consume."""
    np.savez(path, **flatten_tree(tree))


def unflatten_tree(flat: Mapping[str, Array], sep: str = "/") -> Tree:
    """The nested tree of a '/'-keyed mapping (the inverse of
    ``flatten_tree``)."""
    tree: Tree = {}
    for key, value in flat.items():
        *path, leaf = key.split(sep)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def model_template(model) -> Tree:
    """The template ``model_from_torch`` fills: the nested tree of a port
    model's parameters, named as flax names them (``weights.export_params``),
    in place of the JAX tool's ``model.init(...)['params']``."""
    from vqa_tpu_torch.weights import export_params

    return unflatten_tree(export_params(model))
