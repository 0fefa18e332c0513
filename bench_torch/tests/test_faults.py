"""A run with the timed path broken underneath comes out not correct.

Each case drives a whole run of a small copy of a cell on the CPU (no look
for a card) with one fault planted in the program's entry points."""

import pytest
import torch

import mgard_tpu_torch
import mgard_tpu_torch.mdr as mdr
import run
from conftest import small_cell


def _altered(fn, change):
    def wrapped(*a, **k):
        out, st = fn(*a, **k)
        return (change(out) if out is not None else out), st
    return wrapped


def _stale(fn):
    """decompress returning the field of its first call, whatever it is
    given: a step that returns its state unchanged."""
    first = []

    def wrapped(*a, **k):
        out, st = fn(*a, **k)
        if not first:
            first.append(out)
        return first[0], st
    return wrapped


def _one_value(out):
    out = out.clone(memory_format=torch.contiguous_format)
    out.view(-1)[out.numel() // 3] += 3e-3
    return out


def _half_left_out(out):
    out = out.clone(memory_format=torch.contiguous_format)
    out.view(-1)[: out.numel() // 2] = 0.0
    return out


def _inside_the_bound(out):
    # every value moved by 0.3 tol: the bound may still
    # hold, the agreement with the reference does not
    return out + 3e-4


ROUNDTRIP_FAULTS = {
    "answer_altered": lambda m: m.setattr(
        mgard_tpu_torch, "decompress",
        _altered(mgard_tpu_torch.decompress, _one_value)),
    "half_left_out": lambda m: m.setattr(
        mgard_tpu_torch, "decompress",
        _altered(mgard_tpu_torch.decompress, _half_left_out)),
    "state_unchanged": lambda m: m.setattr(
        mgard_tpu_torch, "decompress", _stale(mgard_tpu_torch.decompress)),
    "inside_the_bound": lambda m: m.setattr(
        mgard_tpu_torch, "decompress",
        _altered(mgard_tpu_torch.decompress, _inside_the_bound)),
}


def _recon_altered(change):
    real = mdr.MDReconstruct

    def wrapped(*a, **k):
        out = real(*a, **k)
        out.data = change(out.data)
        return out
    return wrapped


def _recon_stale():
    """Every read returns the planes of the first read it was asked for."""
    real = mdr.MDReconstruct
    first = []

    def wrapped(meta, data, counts=None, **k):
        if not first:
            first.append(list(counts))
        return real(meta, data, first[0], **k)
    return wrapped


def _undercounted(real):
    return lambda meta, counts: real(meta, counts) // 2


PROGRESSIVE_FAULTS = {
    "answer_altered": lambda m: m.setattr(
        mdr, "MDReconstruct", _recon_altered(_one_value)),
    "half_left_out": lambda m: m.setattr(
        mdr, "MDReconstruct", _recon_altered(_half_left_out)),
    "state_unchanged": lambda m: m.setattr(mdr, "MDReconstruct",
                                           _recon_stale()),
    "bytes_undercounted": lambda m: m.setattr(
        mdr, "retrieve_size", _undercounted(mdr.retrieve_size)),
}


def _run(tmp_path, cell, size):
    spec, name, roots = small_cell(tmp_path, cell, size)
    r, _ = run.run_cell(spec, name, 2**31 + 11, 0.3, False, "cpu",
                        roots=roots)
    return r


@pytest.mark.parametrize("fault", sorted(ROUNDTRIP_FAULTS))
def test_roundtrip_fault_fails(tmp_path, monkeypatch, fault):
    ROUNDTRIP_FAULTS[fault](monkeypatch)
    r = _run(tmp_path, "nyx512.bfp.roundtrip", 64)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", sorted(PROGRESSIVE_FAULTS))
def test_progressive_fault_fails(tmp_path, monkeypatch, fault):
    PROGRESSIVE_FAULTS[fault](monkeypatch)
    r = _run(tmp_path, "mdr384.zlib.progressive", 48)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell,size", [("nyx512.bfp.roundtrip", 64),
                                       ("mdr384.zlib.progressive", 48)])
def test_sound_small_runs_are_correct(tmp_path, cell, size):
    r = _run(tmp_path, cell, size)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
