"""The check has to fail what is wrong: the control (the reference one
precision below the configuration's, in the program's place) and the timed
path broken underneath, each driven through a whole run of the cell (its
entry, inputs, window and check) at a size a CPU test holds. The faults a
cell can have: a call that returns its state unchanged (the previous
answer), half of the answer left out, and an answer altered where it is
produced. Exchanges between chips: every cell runs on one chip. Every cell
of BENCHMARK.json goes through these, and so does each configuration file
and traffic mix that no cell names yet (conftest.with_unnamed)."""

import pytest

import sz3_tpu_torch
from sz3_tpu_torch import serving
from szbench.reference.control import Control

from .conftest import ALL, run_small


@pytest.mark.parametrize("name", ALL)
def test_sound_run_is_correct(name):
    r = run_small(name)
    assert r["correct"], r["checks"]
    assert r["checks"]["max_err_over_eb"]["value"] <= 1.0 and r["failed"] == 0


@pytest.mark.parametrize("name", ALL)
def test_control_is_not_correct(name):
    r = run_small(name, program=Control("cpu"))
    assert not r["correct"]
    assert r["checks"]["max_err_over_eb"]["value"] > 3.0     # bfloat16 misses REL 1e-4 widely


def _patch_decode(monkeypatch, change):
    """Every decode of a field (single calls and the batch's) passes its
    output through change(out)."""
    real = sz3_tpu_torch.decompress

    def broken(blob, **kw):
        out, conf = real(blob, **kw)
        return change(out), conf

    monkeypatch.setattr(sz3_tpu_torch, "decompress", broken)
    monkeypatch.setattr(serving, "decompress", broken)


def stale(monkeypatch):
    last = []

    def change(out):
        last.append(out)
        return last[-2] if len(last) > 1 else out
    _patch_decode(monkeypatch, change)


def half_left_out(monkeypatch):
    def change(out):
        out = out.clone()
        out.view(-1)[out.numel() // 2:] = 0
        return out
    _patch_decode(monkeypatch, change)
    real = serving.decompress_batch
    monkeypatch.setattr(serving, "decompress_batch",
                        lambda blobs, **kw: real(blobs[:len(blobs) // 2], **kw))


def altered(monkeypatch):
    def change(out):
        out = out.clone()
        out.view(-1)[out.numel() // 3] += 0.01     # some 17 eb at REL 1e-4 of a range of 5.9
        return out
    _patch_decode(monkeypatch, change)


@pytest.mark.parametrize("fault", [stale, half_left_out, altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", ALL)
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    r = run_small(name)
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ALL)
def test_cells_on_card(card, name):
    r = run_small(name, device=card)
    assert r["correct"], r["checks"]
    r = run_small(name, device=card, program=Control(card))
    assert not r["correct"]


def test_the_check_holds_a_sample_drawn_from_the_seed():
    import torch

    from szbench.harness import cell

    def held(seed, n):
        ctx = cell.Context(None, None, [None], "cpu", seed)
        for i in range(n):
            ctx.keep(i, torch.full((2,), float(i)))
        return ctx.offered, sorted(k for k, _ in ctx.kept)

    offered, kept = held(2**31 + 11, 50)
    assert offered == 50 and len(kept) == cell.SAMPLE and len(set(kept)) == cell.SAMPLE
    assert held(2**31 + 11, 50) == (offered, kept)
    assert held(5, 3) == (3, [0, 1, 2])
    assert len({tuple(held(s, 50)[1]) for s in range(8)}) > 1
