"""The multi-card paths' host-side logic, with no card and no jax: the card
``parallel.initialize`` gives each rank (``torch.cuda`` and the process group
patched), ``chip_smoke.py``'s phase selector (``--only multicard``), its
``_rank_setup`` (gloo on cuda:0 for [parallel], NCCL on cuda:<rank> for
[multicard]) and the helpers [multicard] holds its ranks with. The four-card
run itself is ``python3 chip_smoke.py --only multicard`` on a host of four
cards."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import chip_smoke
from vqa_tpu_torch.parallel import distributed

torch.set_num_threads(1)
# the phases a run with no argument has run, in order, since [parallel]
ONE_CARD_PHASES = ("device", "kernels", "f32_kernels", "eval", "serve", "grid", "f32_path",
                   "eval_cli", "data", "train_ops", "train", "train_cli", "export", "parallel",
                   "fixture_matrix", "extract", "large_shapes")


@pytest.fixture
def cards(monkeypatch):
    """Four fake cards and a fake process group: records every set_device,
    init_process_group and new_group, in order."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.append(("set_device", torch.device(d))))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, init_method=None, **kw: calls.append(
                            ("init_process_group", backend, init_method, kw)))
    monkeypatch.setattr(dist, "new_group",
                        lambda *a, **kw: calls.append(("new_group", kw.get("backend"))) or "side")
    monkeypatch.setattr(distributed, "_HOST_GROUP", None)
    for key in ("RANK", "LOCAL_RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    return calls


def test_initialize_takes_local_rank_from_torchrun(cards, monkeypatch):
    monkeypatch.setenv("RANK", "6")
    monkeypatch.setenv("LOCAL_RANK", "1")
    dev = distributed.initialize(device="cuda")
    assert dev == torch.device("cuda", 1)
    assert cards[0] == ("set_device", torch.device("cuda", 1))
    assert cards[1] == ("init_process_group", "nccl", "env://", {})
    assert cards[2] == ("new_group", "gloo")  # the side group for host tensors


@pytest.mark.parametrize("rank, card", [(0, 0), (3, 3), (5, 1)])
def test_initialize_without_local_rank_takes_rank_mod_cards(cards, rank, card):
    dev = distributed.initialize("localhost:29500", 8, rank, device="cuda")
    assert dev == torch.device("cuda", card)
    assert [c[0] for c in cards] == ["set_device", "init_process_group", "new_group"]
    assert cards[0] == ("set_device", torch.device("cuda", card))
    assert cards[1] == ("init_process_group", "nccl", "tcp://localhost:29500",
                        {"world_size": 8, "rank": rank})


def test_initialize_honours_a_card_index(cards, monkeypatch):
    """gloo ranks sharing one card name it: on a host of four cards each
    still lands on cuda:0 (the index was dropped before, so rank r took
    cuda:r % 4), and LOCAL_RANK does not move it."""
    monkeypatch.setenv("LOCAL_RANK", "2")
    for rank in range(4):
        dev = distributed.initialize("file:///store", 4, rank, backend="gloo", device="cuda:0")
        assert dev == torch.device("cuda", 0)
    assert [c for c in cards if c[0] == "set_device"] == [("set_device",
                                                            torch.device("cuda", 0))] * 4
    assert not [c for c in cards if c[0] == "new_group"]  # gloo carries host tensors itself


@pytest.mark.parametrize("backend, cards_of_ranks, device_arg",
                         [("gloo", [0, 0, 0, 0], "cuda:0"), ("nccl", [0, 1, 2, 3], "cuda")])
def test_rank_setup_places_parallel_and_multicard_ranks(cards, monkeypatch, backend,
                                                        cards_of_ranks, device_arg):
    seen = []
    real = distributed.initialize

    def recording(*args, **kwargs):
        seen.append(kwargs)
        return real(*args, **kwargs)

    from vqa_tpu_torch import parallel

    monkeypatch.setattr(parallel, "initialize", recording)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        torch.backends.cuda.matmul.allow_tf32)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", torch.backends.cudnn.allow_tf32)
    devs = [chip_smoke._rank_setup(r, 4, "file:///store", backend)[2] for r in range(4)]
    assert devs == [torch.device("cuda", i) for i in cards_of_ranks]
    assert [k["backend"] for k in seen] == [backend] * 4
    assert [k["device"] for k in seen] == [device_arg] * 4
    assert [c[1] for c in cards if c[0] == "init_process_group"] == [backend] * 4
    assert not torch.backends.cuda.matmul.allow_tf32


def test_default_phases_are_the_one_card_run():
    assert chip_smoke._phases([]) == ONE_CARD_PHASES
    assert chip_smoke._phases(["--only", "multicard"]) == ("device", "multicard")


def test_unknown_phase_is_refused(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main(["--only", "parallel"])
    assert e.value.code == 2
    out = capsys.readouterr()
    assert out.out == "" and "invalid choice: 'parallel'" in out.err


def _no_phase_runs(monkeypatch):
    from vqa_tpu_torch.ops import _build

    def refuse(*a, **k):
        raise AssertionError("a phase ran")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(chip_smoke, "_multicard_main", refuse)
    monkeypatch.setattr(chip_smoke.subprocess, "run", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        torch.backends.cuda.matmul.allow_tf32)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", torch.backends.cudnn.allow_tf32)


@pytest.mark.parametrize("count", [1, 2, 3])
def test_multicard_on_fewer_than_four_cards_exits_before_any_phase(monkeypatch, capsys, count):
    _no_phase_runs(monkeypatch)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    assert chip_smoke.main(["--only", "multicard"]) != 0
    out = capsys.readouterr()
    assert out.out == ""  # no phase line, no result line
    assert f"this host has {count} card(s)" in out.err and "runs 4 ranks" in out.err


def test_no_argument_runs_the_one_card_phases_on_four_cards(monkeypatch):
    """With four cards and no argument the script still takes the one-card
    path (its first device query), not [multicard]."""
    _no_phase_runs(monkeypatch)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(AssertionError, match="a phase ran"):
        chip_smoke.main([])


def test_track_writes_records_what_a_rank_writes_under_the_run(tmp_path):
    run, other = tmp_path / "run", tmp_path / "other"
    run.mkdir()
    other.mkdir()
    (run / "read.json").write_text("{}")
    with chip_smoke._track_writes(str(run)) as seen:
        with open(run / "read.json") as f:
            f.read()
        with open(run / "metrics.jsonl", "a") as f:
            f.write("{}\n")
        np.savez(run / "params.npz", a=np.zeros(2))
        with open(other / "elsewhere.txt", "w") as f:
            f.write("x")
        os.makedirs(run / "ckpt" / "epoch_0000.tmp")
        with open(run / "ckpt" / "epoch_0000.tmp" / "state.json", "w") as f:
            f.write("{}")
        os.replace(run / "ckpt" / "epoch_0000.tmp", run / "ckpt" / "epoch_0000")
    assert sorted(seen) == ["ckpt/epoch_0000", "ckpt/epoch_0000.tmp/state.json",
                            "metrics.jsonl", "params.npz"]
    with open(run / "after.txt", "w") as f:  # the patches are gone
        f.write("x")
    assert "after.txt" not in seen


def test_nccl_summary_reads_transports_nvls_and_algorithms(tmp_path):
    log = tmp_path / "rank0.log"
    log.write_text("\n".join([
        "host:1:1 [0] NCCL INFO NCCL version 2.27.3+cuda12.9",
        "host:1:9 [0] NCCL INFO Channel 00/0 : 0[0] -> 1[1] via P2P/CUMEM/read",
        "host:1:9 [0] NCCL INFO Channel 01/0 : 0[0] -> 1[1] via P2P/CUMEM/read",
        "host:1:9 [0] NCCL INFO NVLS multicast support is available on dev 0 (NVLS_NCHANNELS 16)",
        "host:1:9 [0] NCCL INFO Algorithm   |    CollNetChain   |     NVLS     |    NVLSTree   |",
        "host:1:9 [0] NCCL INFO Connected all rings, use ring PXN 0 GDR 1",
        "host:1:9 [0] NCCL INFO AllReduce: 184549376 Bytes -> Algo 4 proto 2 time 312.5",
        "host:1:9 [0] NCCL INFO AllReduce: 184549380 Bytes -> Algo 4 proto 2 time 312.6",
        "unrelated line with Algo in it",
    ]))
    got = chip_smoke._nccl_summary(str(log))
    assert got["version"] == "2.27.3+cuda12.9"
    assert got["transports"] == ["P2P/CUMEM/read"]
    assert len(got["nvls"]) == 1 and got["nvls"][0].startswith("NVLS multicast")
    assert got["algorithms"] == ["AllReduce: 184549376 Bytes -> Algo 4 proto 2 time 312.5"]
    assert got["connected"] == ["Connected all rings, use ring PXN # GDR #"]


def test_signed_zeros_plants_both_signs():
    table = np.ones((3, 4, 8), np.float32)
    out = chip_smoke._signed_zeros(table)
    flat = out.reshape(3, -1)
    assert np.signbit(flat[:, ::7]).all() and not flat[:, ::7].any()
    assert not np.signbit(flat[:, 5::11]).any() and not flat[:, 5::11].any()
    assert (table == 1).all()  # a copy


class _Recurrent(torch.nn.Module):
    """A parameter named as the LSTM's recurrent kernel, which init_params
    fills by a QR."""

    def __init__(self):
        super().__init__()
        self.wh = torch.nn.Parameter(torch.empty(256, 1024))


@pytest.mark.parametrize("threads", [3, 8])
def test_seeded_init_does_not_depend_on_the_thread_count(threads):
    """torchrun starts its workers with OMP_NUM_THREADS=1, so a seed must give
    them one process's weights: the QR of ``wh`` summed in an order set by
    the thread count, and the train CLI under torchrun as a 1 x 4 mesh
    started from other weights than one process (found on four cards)."""
    from vqa_tpu_torch.weights import init_params

    def init(n):
        torch.set_num_threads(n)
        model = _Recurrent()
        init_params(model, 0)
        assert torch.get_num_threads() == n  # the QR's count is its own
        return model.wh.detach().clone()

    try:
        assert torch.equal(init(threads), init(1))
    finally:
        torch.set_num_threads(1)
