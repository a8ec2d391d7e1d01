"""The port's torch-weight importers (vqa_tpu_torch/importers.py and
``python -m vqa_tpu_torch.tools.import_torch``) against the JAX package's
(vqa_tpu/importers.py, tools/import_torch.py).

Both sides are numpy, so every converter must give a tree equal to the
JAX one leaf for leaf, bit for bit, on the same state_dicts: the
torchvision-named ResNet at one block a stage and at resnet50 depth, the
seq2vec GRU and LSTM with one and two layers, the theano skip-thoughts npz,
the vocabulary alignment, and ``model_from_torch`` under every
options/import_specs/*.json (the MFB and MFH specs with their pool_perm
inverse) over the port's template, whose leaves and shapes must be flax's
``model.init``'s. Each tool writes the same npz on the same checkpoint, and
``--show`` and the ``--allow_unfilled`` refusal behave alike. A port model
loaded with an imported checkpoint reproduces the lineage-named torch
mirror's logits (tests/test_importers.py, tests/test_importers_full_models.py)
to 1e-4 in float32, for MutanAtt, MLBAtt, MutanNoAtt, MLBNoAtt, ConcatAtt,
MFBCoAtt, MFHCoAtt and CoR; the imported ResNet reproduces the torch
ResNet's grid.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch import nn as tnn

from test_importers import STAGES, TMLBAtt, TMutanAtt, TResNet, _randomize
from test_importers_full_models import K, TCoR, TConcatAtt, TMFBCoAtt
from tools.import_torch import main as jax_cli
from vqa_tpu import importers as jax_importers
from vqa_tpu_torch import importers
from vqa_tpu_torch.config import load_options
from vqa_tpu_torch.models import convnets
from vqa_tpu_torch.models.factory import factory as model_factory
from vqa_tpu_torch.tools.import_torch import main as port_cli
from vqa_tpu_torch.weights import load_params

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4  # the imported port model against the torch mirror, float32 on both sides


class TMLBNoAtt(tnn.Module):
    """Torch mirror of MLBNoAtt in the lineage's naming
    (options/import_specs/mlb_noatt.json): tanh projections of q and the
    pooled image vector, their product, the classifier."""

    def __init__(self, V, E, H, dv, h, nans):
        super().__init__()
        self.seq2vec = tnn.Module()
        self.seq2vec.embedding = tnn.Embedding(V, E)
        self.seq2vec.rnn = tnn.LSTM(E, H, batch_first=True)
        self.linear_q_fusion = tnn.Linear(H, h)
        self.linear_v_fusion = tnn.Linear(dv, h)
        self.linear_classif = tnn.Linear(h, nans)

    def forward(self, v, tokens):
        out, _ = self.seq2vec.rnn(self.seq2vec.embedding(tokens))
        z = torch.tanh(self.linear_q_fusion(out[:, -1])) * torch.tanh(self.linear_v_fusion(v))
        return self.linear_classif(z)


class TMutanNoAtt(tnn.Module):
    """Torch mirror of MutanNoAtt (a copy of the one inside
    tests/test_importers.py::test_full_mutan_noatt_checkpoint_import_matches_torch)."""

    def __init__(self, V, E, H, dv, hq, hv, M, R, nans):
        super().__init__()
        self.seq2vec = tnn.Module()
        self.seq2vec.embedding = tnn.Embedding(V, E)
        self.seq2vec.rnn = tnn.LSTM(E, H, batch_first=True)
        self.linear_q_fusion = tnn.Linear(H, hq)
        self.linear_v_fusion = tnn.Linear(dv, hv)
        self.fusion = tnn.Module()
        self.fusion.list_linear_hq = tnn.ModuleList([tnn.Linear(hq, M) for _ in range(R)])
        self.fusion.list_linear_hv = tnn.ModuleList([tnn.Linear(hv, M) for _ in range(R)])
        self.linear_classif = tnn.Linear(M, nans)

    def forward(self, v, tokens):
        out, _ = self.seq2vec.rnn(self.seq2vec.embedding(tokens))
        q = torch.tanh(self.linear_q_fusion(out[:, -1]))
        x_v = torch.tanh(self.linear_v_fusion(v))
        return self.linear_classif(TMutanAtt._tucker(self.fusion, q, x_v))


# arch -> (spec, mirror, yaml, V, nans, regions (None: pooled), dv, T), at the
# widths of the JAX package's importer tests
CASES = {
    "MutanAtt": ("mutan_att",
                 lambda: TMutanAtt(19, 6, 8, 10, 7, 9, 11, 3, 2, 6, 8, 12, 2, 13), """
model:
  arch: MutanAtt
  seq2vec: {arch: lstm, emb_size: 6, hidden_size: 8}
  attention: {nb_glimpses: 2, dim_hq: 7, dim_hv: 9, dim_mm: 11, R: 3}
  fusion: {arch: mutan, dim_hq: 6, dim_hv: 8, dim_mm: 12, R: 2}
""", 19, 13, 5, 10, 7),
    "MLBAtt": ("mlb_att", lambda: TMLBAtt(17, 5, 7, 9, 10, 2, 8, 12), """
model:
  arch: MLBAtt
  seq2vec: {arch: lstm, emb_size: 5, hidden_size: 7}
  attention: {nb_glimpses: 2, dim_h: 10}
  fusion: {arch: mlb, dim_h: 8}
""", 17, 12, 4, 9, 6),
    "MutanNoAtt": ("mutan_noatt", lambda: TMutanNoAtt(15, 4, 6, 8, 5, 7, 9, 2, 11), """
model:
  arch: MutanNoAtt
  seq2vec: {arch: lstm, emb_size: 4, hidden_size: 6}
  fusion: {arch: mutan, dim_hq: 5, dim_hv: 7, dim_mm: 9, R: 2}
""", 15, 11, None, 8, 5),
    "MLBNoAtt": ("mlb_noatt", lambda: TMLBNoAtt(16, 5, 6, 8, 7, 10), """
model:
  arch: MLBNoAtt
  seq2vec: {arch: lstm, emb_size: 5, hidden_size: 6}
  fusion: {arch: mlb, dim_h: 7}
""", 16, 10, None, 8, 6),
    "ConcatAtt": ("concat_att", lambda: TConcatAtt(13, 4, 6, 8, 9, 1, 10, 11), """
model:
  arch: ConcatAtt
  seq2vec: {arch: lstm, emb_size: 4, hidden_size: 6}
  attention: {nb_glimpses: 1, dim_h: 9, activation: tanh}
  fusion: {arch: concat}
  classif: {dim_h: 10}
""", 13, 11, 5, 8, 7),
    "MFBCoAtt": ("mfb_coatt", lambda: TMFBCoAtt(15, 4, 6, 8, 2, 9, 6, 2, 7, 12), f"""
model:
  arch: MFBCoAtt
  seq2vec: {{arch: lstm, emb_size: 4, hidden_size: 6, return_sequence: true}}
  attention: {{nb_glimpses: 2, question_glimpses: 2, dim_h: 9, dim_mm: 6}}
  fusion: {{arch: mfb, pool_factor: {K}, dim_mm: 7}}
""", 15, 12, 5, 8, 7),
    "MFHCoAtt": ("mfh_coatt", lambda: TMFBCoAtt(15, 4, 6, 8, 2, 9, 6, 2, 7, 12, mfh=True), f"""
model:
  arch: MFHCoAtt
  seq2vec: {{arch: lstm, emb_size: 4, hidden_size: 6, return_sequence: true}}
  attention: {{nb_glimpses: 2, question_glimpses: 2, dim_h: 9, dim_mm: 6}}
  fusion: {{arch: mfh, pool_factor: {K}, dim_mm: 7}}
""", 15, 12, 5, 8, 7),
    "CoR": ("cor", lambda: TCoR(14, 4, 6, 8, 8, 3, 9, 10), """
model:
  arch: CoR
  seq2vec: {arch: lstm, emb_size: 4, hidden_size: 6}
  fusion: {arch: cor, dim_h: 8}
  classif: {dim_h: 9}
  chain: {steps: 3}
""", 14, 10, 6, 8, 7),
}


def _assert_same_tree(got, want):
    """Two trees (nested or '/'-keyed) equal leaf for leaf: keys, dtypes,
    shapes and every bit."""
    got, want = importers.flatten_tree(got), jax_importers.flatten_tree(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def mirrors(tmp_path_factory):
    """Each arch's mirror (seeded), its checkpoint (a {'state_dict': ...}
    wrapper, as the lineage saves) and its YAML."""
    d = tmp_path_factory.mktemp("mirrors")
    out = {}
    for i, (arch, (spec, make, yaml, *dims)) in enumerate(CASES.items()):
        torch.manual_seed(i)
        tmodel = make().eval()
        with torch.no_grad():  # non-zero biases throughout
            for p in tmodel.parameters():
                p.add_(0.05 * torch.randn(p.shape))
        ckpt, path_opt = d / f"{spec}.pth", d / f"{spec}.yaml"
        torch.save({"state_dict": tmodel.state_dict()}, ckpt)
        path_opt.write_text(yaml)
        out[arch] = (spec, tmodel, str(ckpt), str(path_opt), *dims)
    return out


def _port_model(path_opt, V, nans, dv):
    opt = load_options(path_opt)
    return model_factory(dataclasses.asdict(opt.model), V, nans, dim_v=dv)


def _cli_args(ckpt, path_opt, V, nans, Rg, dv):
    return [ckpt, "--kind", "model", "--path_opt", path_opt, "--num_words", str(V),
            "--num_answers", str(nans), "--regions", str(Rg or 3), "--feature_dim", str(dv)]


# ---------------------------------------------------------------- converters


@pytest.mark.parametrize("stages", [STAGES, convnets._DEPTHS["resnet50"]],
                         ids=["one_block_a_stage", "resnet50"])
def test_resnet_from_torch_matches_jax(stages):
    tmodel = TResNet(stages)
    _randomize(tmodel, 0)
    sd = {f"module.{k}": v for k, v in _sd(tmodel).items()}
    _assert_same_tree(importers.resnet_from_torch(sd, stages),
                      jax_importers.resnet_from_torch(sd, stages))


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("layers", [1, 2])
def test_seq_encoder_from_torch_matches_jax(cell, layers):
    emb = tnn.Embedding(20, 5)
    rnn = (tnn.GRU if cell == "gru" else tnn.LSTM)(5, 6, num_layers=layers, batch_first=True)
    sd = {f"embedding.{k}": v for k, v in _sd(emb).items()}
    sd.update({f"rnn.{k}": v for k, v in _sd(rnn).items()})
    _assert_same_tree(importers.seq_encoder_from_torch(sd, cell, layers),
                      jax_importers.seq_encoder_from_torch(sd, cell, layers))


def _theano(rng, E=5, H=6):
    return {
        "encoder_W": rng.standard_normal((E, 2 * H)).astype(np.float32),
        "encoder_b": rng.standard_normal(2 * H).astype(np.float32),
        "encoder_U": rng.standard_normal((H, 2 * H)).astype(np.float32),
        "encoder_Wx": rng.standard_normal((E, H)).astype(np.float32),
        "encoder_bx": rng.standard_normal(H).astype(np.float32),
        "encoder_Ux": rng.standard_normal((H, H)).astype(np.float32),
        "Wemb": rng.standard_normal((9, E)).astype(np.float32),
    }


def test_skipthoughts_from_theano_matches_jax():
    theano = _theano(np.random.default_rng(11))
    _assert_same_tree(importers.skipthoughts_from_theano(theano),
                      jax_importers.skipthoughts_from_theano(theano))
    bad = dict(theano, encoder_W=theano["encoder_W"][:, :5])
    with pytest.raises(ValueError, match="inconsistent skip-thoughts dims"):
        importers.skipthoughts_from_theano(bad)


@pytest.mark.parametrize("oov", ["zeros", "mean"])
def test_align_embedding_to_vocab_matches_jax(oov):
    table = np.random.default_rng(3).standard_normal((6, 4)).astype(np.float32)
    source = ["cat", "dog", "fish", "bird", "cow", "yak"]
    target = ["<pad>", "<unk>", "dog", "yeti", "yak", "cat"]
    got, n = importers.align_embedding_to_vocab(table, source, target, oov)
    want, n_want = jax_importers.align_embedding_to_vocab(table, source, target, oov)
    assert n == n_want == 2 and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", list(CASES))
def test_model_from_torch_matches_jax(mirrors, arch):
    """The spec applied by both packages to the same state_dict and the
    port's template gives the same tree and report; the port template's
    leaves and shapes are flax ``model.init``'s."""
    import jax
    import jax.numpy as jnp

    from vqa_tpu.config import load_options as jax_load_options
    from vqa_tpu.models import factory as jax_model_factory

    spec, tmodel, _, path_opt, V, nans, Rg, dv, T = mirrors[arch]
    template = importers.model_template(_port_model(path_opt, V, nans, dv))
    visual = jnp.zeros((2, dv) if Rg is None else (2, Rg, dv), jnp.float32)
    jax_model = jax_model_factory(jax_load_options(path_opt).model, V, nans)
    flax_template = jax_model.init(jax.random.key(0), visual, jnp.zeros((2, T), jnp.int32),
                                   jnp.ones((2,), jnp.int32))["params"]
    assert ({k: v.shape for k, v in importers.flatten_tree(template).items()}
            == {k: v.shape for k, v in jax_importers.flatten_tree(flax_template).items()})
    with open(os.path.join(REPO, "options", "import_specs", f"{spec}.json")) as f:
        entries = json.load(f)["entries"]
    sd = _sd(tmodel)
    got, got_report = importers.model_from_torch(sd, template, entries)
    want, want_report = jax_importers.model_from_torch(sd, template, entries)
    _assert_same_tree(got, want)
    assert got_report == want_report and not got_report["unfilled"]


def test_pool_perm_rejects_nondivisible_width():
    sd = {"proj.weight": np.zeros((10, 4), np.float32)}
    template = {"p": {"kernel": np.zeros((4, 10)), "bias": np.zeros(10)}}
    with pytest.raises(ValueError, match="pool_perm"):
        importers.model_from_torch(
            sd, template, [{"path": "p", "kind": "dense", "key": "proj", "pool_perm": 3}])


# ---------------------------------------------------------------- the tools


@pytest.mark.parametrize("arch", list(CASES))
def test_import_model_cli_matches_jax_and_the_mirror(mirrors, tmp_path, arch, capsys):
    """--kind model: the port tool's npz equals the JAX tool's, with the same
    message, and the port model loaded from it gives the mirror's logits."""
    spec, tmodel, ckpt, path_opt, V, nans, Rg, dv, T = mirrors[arch]
    args = _cli_args(ckpt, path_opt, V, nans, Rg, dv)
    assert port_cli(args + ["--out", str(tmp_path / "port.npz")]) == 0
    port_msg = capsys.readouterr().out.replace("port.npz", "X")
    assert jax_cli(args + ["--out", str(tmp_path / "jax.npz")]) == 0
    assert capsys.readouterr().out.replace("jax.npz", "X") == port_msg
    flat = _npz(tmp_path / "port.npz")
    _assert_same_tree(flat, _npz(tmp_path / "jax.npz"))

    model = _port_model(path_opt, V, nans, dv)
    load_params(model, flat)
    rng = np.random.default_rng(9)
    v = rng.standard_normal((3, dv) if Rg is None else (3, Rg, dv)).astype(np.float32)
    tokens = rng.integers(1, V, (3, T))
    with torch.no_grad():
        ours = model(torch.from_numpy(v), torch.from_numpy(tokens).int(),
                     torch.full((3,), T, dtype=torch.int32)).numpy()
        theirs = tmodel(torch.from_numpy(v), torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(ours, theirs, rtol=TOL, atol=TOL)


def test_import_resnet_cli_matches_jax_and_the_torch_resnet(tmp_path, capsys):
    """--kind resnet50 on a torchvision-named checkpoint ('module.'
    prefixes, a {'state_dict': ...} wrapper, an fc head that is dropped):
    the same npz and message as the JAX tool's, and the port ResNet loaded
    from it gives the torch ResNet's grid (NCHW there) at 64x64 to 1e-4."""
    from vqa_tpu.models.convnets import _DEPTHS as JAX_DEPTHS

    assert convnets._DEPTHS == JAX_DEPTHS
    stages = convnets._DEPTHS["resnet50"]
    tmodel = TResNet(stages)
    _randomize(tmodel, 1)
    with torch.no_grad():  # keep the grid O(1) through 16 blocks
        for name, m in tmodel.named_modules():
            if name.endswith("bn3"):
                m.weight.mul_(0.2)
    tmodel.eval()
    sd = {f"module.{k}": v for k, v in tmodel.state_dict().items()}
    sd["module.fc.weight"], sd["module.fc.bias"] = torch.randn(10, 2048), torch.randn(10)
    ckpt = tmp_path / "r50.pth"
    torch.save({"state_dict": sd}, ckpt)
    assert port_cli([str(ckpt), "--kind", "resnet50", "--out", str(tmp_path / "port.npz")]) == 0
    port_msg = capsys.readouterr().out.replace("port.npz", "X")
    assert jax_cli([str(ckpt), "--kind", "resnet50", "--out", str(tmp_path / "jax.npz")]) == 0
    assert capsys.readouterr().out.replace("jax.npz", "X") == port_msg
    flat = _npz(tmp_path / "port.npz")
    _assert_same_tree(flat, _npz(tmp_path / "jax.npz"))
    assert not any("fc" in k for k in flat)

    model = convnets.factory("resnet50")
    convnets.load_variables(model, flat)
    x = np.random.default_rng(2).standard_normal((2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
        theirs = tmodel(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(ours, theirs, rtol=TOL, atol=TOL * np.abs(theirs).max())


def test_import_encoder_clis_match_jax(tmp_path, capsys):
    """--kind seq2vec (gru and lstm, 1 and 2 layers), skipthoughts and
    embedding: the same npz and message as the JAX tool's."""
    emb = tnn.Embedding(9, 4)
    rnn = {cell: (tnn.GRU if cell == "gru" else tnn.LSTM)(4, 5, num_layers=2, batch_first=True)
           for cell in ("gru", "lstm")}
    runs = []
    for cell in ("gru", "lstm"):
        sd = {f"module.embedding.{k}": v for k, v in emb.state_dict().items()}
        sd.update({f"module.rnn.{k}": v for k, v in rnn[cell].state_dict().items()})
        torch.save({"state_dict": sd}, tmp_path / f"{cell}.pth")
        for layers in (1, 2):
            runs.append([str(tmp_path / f"{cell}.pth"), "--kind", "seq2vec", "--cell", cell,
                         "--num_layers", str(layers)])
    np.savez(tmp_path / "uni_skip.npz", **_theano(np.random.default_rng(13), 4, 5))
    runs.append([str(tmp_path / "uni_skip.npz"), "--kind", "skipthoughts"])
    (tmp_path / "words.txt").write_text("".join(f"w{i}\n" for i in range(9)))
    (tmp_path / "vocab.json").write_text(json.dumps(
        {"wid_to_word": ["<pad>", "<unk>", "w3", "nope", "w7"], "aid_to_ans": []}))
    for oov in ("zeros", "mean"):
        runs.append([str(tmp_path / "gru.pth"), "--kind", "embedding", "--source_words",
                     str(tmp_path / "words.txt"), "--vocab", str(tmp_path / "vocab.json"),
                     "--oov", oov])
    for args in runs:
        assert port_cli(args + ["--out", str(tmp_path / "port.npz")]) == 0
        port_msg = capsys.readouterr().out.replace("port.npz", "X")
        assert jax_cli(args + ["--out", str(tmp_path / "jax.npz")]) == 0
        assert capsys.readouterr().out.replace("jax.npz", "X") == port_msg, args
        _assert_same_tree(_npz(tmp_path / "port.npz"), _npz(tmp_path / "jax.npz"))


def test_import_cli_show_matches_jax(mirrors, tmp_path, capsys):
    """--show prints the same torch keys and model leaves as the JAX tool."""
    spec, _, ckpt, path_opt, V, nans, Rg, dv, _ = mirrors["MFBCoAtt"]
    args = _cli_args(ckpt, path_opt, V, nans, Rg, dv) + ["--out", str(tmp_path / "x.npz"),
                                                         "--show"]
    assert port_cli(args) == 0
    port_out = capsys.readouterr().out
    assert jax_cli(args) == 0
    assert capsys.readouterr().out == port_out
    assert "seq2vec.embedding.weight  (15, 4)" in port_out
    assert "encoder/lstm_0/wx  (4, 24)" in port_out and not (tmp_path / "x.npz").exists()


def test_import_cli_refuses_unfilled_leaves_as_jax(mirrors, tmp_path, capsys):
    """A spec that misses the classifier: both tools refuse with the same
    message; with --allow_unfilled both write every leaf, the imported ones
    equal and the classifier left at its init."""
    spec, _, ckpt, path_opt, V, nans, Rg, dv, _ = mirrors["CoR"]
    with open(os.path.join(REPO, "options", "import_specs", f"{spec}.json")) as f:
        entries = [e for e in json.load(f)["entries"] if not e["path"].startswith("classifier")]
    short = tmp_path / "short.json"
    short.write_text(json.dumps({"entries": entries}))
    args = _cli_args(ckpt, path_opt, V, nans, Rg, dv) + ["--spec", str(short)]
    messages = []
    for cli, out in ((port_cli, "port.npz"), (jax_cli, "jax.npz")):
        with pytest.raises(SystemExit) as e:
            cli(args + ["--out", str(tmp_path / out)])
        messages.append(str(e.value))
        assert not (tmp_path / out).exists()
    assert messages[0] == messages[1] and "classifier/" in messages[0]
    for cli, out in ((port_cli, "port.npz"), (jax_cli, "jax.npz")):
        assert cli(args + ["--out", str(tmp_path / out), "--allow_unfilled"]) == 0
    got, want = _npz(tmp_path / "port.npz"), _npz(tmp_path / "jax.npz")
    assert sorted(got) == sorted(want)
    unfilled = [k for k in got if k.startswith("classifier/")]
    assert unfilled
    _assert_same_tree({k: v for k, v in got.items() if k not in unfilled},
                      {k: v for k, v in want.items() if k not in unfilled})
    assert all(got[k].shape == want[k].shape and np.isfinite(got[k]).all() for k in unfilled)
