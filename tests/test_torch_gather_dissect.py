"""The gather probe's dissection (``kmer_mapper_tpu_torch.scripts.
gather_probe_dissect``) without jax: every variant's wrapper against the
numpy loop on the hazard cases (on the CPU its twin), its refusals and
launch, and its ``main`` at a small size on the CPU. It also runs on the
GPU machine, which has no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gather_dissect.py

Tests of the CUDA kernel itself carry the ``cuda`` marker and skip where
PyTorch sees no GPU."""
import contextlib
import types

import numpy as np
import pytest
import torch

from kmer_mapper_tpu_torch import native
from kmer_mapper_tpu_torch.ops import probe_cases
from kmer_mapper_tpu_torch.scripts import gather_probe_dissect as D

CASES = {c.name: c for c in probe_cases.cases()}
#: hazard cases of every kind the dissection kernel's bits touch: a hot
#: key, block bounds, wrapping chains, invalid queries, negative words, one
#: bucket
NAMES = ["skewed_p2", "block_bounds_p2", "wrapping_chains_p55", "invalid_p2",
         "negative_words_p1", "buckets1_p64"]
SMALL = {"N_QUERIES": 1 << 9, "BENCH_BUCKETS": 1 << 7, "BENCH_KEYS": 315,
         "LARGE_BUCKETS": 1 << 8, "LARGE_KEYS": 1 << 10, "SWEEP_BUCKETS": []}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


def _variants(case, device, options):
    args, kw = case.slot_args(device)
    slots = D.slots_variant(options, *args, **kw)
    args, kw = case.count_args(device)
    counts = D.count_variant(options, *args, **kw)
    return slots, counts


@pytest.mark.parametrize("name", NAMES)
def test_variants_on_cpu_tensors_run_the_twins(name):
    case = CASES[name]
    before = dict(D.launch_counts)
    for options in (0, D.ALL_OPTIONS):
        slots, counts = _variants(case, "cpu", options)
        np.testing.assert_array_equal(slots.numpy(), case.expected_slots())
        np.testing.assert_array_equal(_u32(counts), case.expected_counts())
    assert D.launch_counts == before


@pytest.mark.parametrize("options", [-1, D.ALL_OPTIONS + 1])
def test_options_outside_the_bits_are_refused(options):
    case = CASES["skewed_p2"]
    with pytest.raises(ValueError, match="options"):
        _variants(case, "cpu", options)


def test_other_devices_are_refused():
    args, kw = CASES["skewed_p2"].slot_args("cpu")
    args = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    kw = {k: v.to("meta") for k, v in kw.items()}
    with pytest.raises(ValueError, match="no kernel for device meta"):
        D.slots_variant(0, *args, **kw)


def _fake_cuda_tensor(n_rows, ptr):
    """What the launch reads of a CUDA tensor, without a GPU."""
    return types.SimpleNamespace(device=torch.device("cuda", 0), data_ptr=lambda: ptr,
                                 shape=(n_rows, 8))


def test_launch_passes_the_options_and_a_failure_raises(monkeypatch):
    """The options go between the mode and the device; a launch that
    returns an error raises and counts nothing; a CPU tensor never reaches
    the kernel."""
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    calls, rc = [], [0]
    lib = types.SimpleNamespace(
        gather_probe_dissect_launch=lambda *a: calls.append(a) or rc[0],
        kmt_error_string=lambda rc: b"invalid argument",
    )
    monkeypatch.setattr(native, "library", lambda: lib)
    key, queries, counts = (_fake_cuda_tensor(n, ptr)
                            for n, ptr in ((8, 16), (5, 32), (64, 48)))
    before = D.launch_counts["gather_probe_dissect"]
    D._launch(0, D.NO_AGGREGATE, key, key, None, queries, None, counts, None, 2, 7)
    (args,) = calls
    # n, n_buckets, n_blocks, max_probe, seed, mode, options, then the device and stream
    assert args[7:14] == (5, 8, 0, 2, 7, 0, D.NO_AGGREGATE) and len(args) == 16
    assert D.launch_counts["gather_probe_dissect"] == before + 1
    rc[0] = 1
    with pytest.raises(RuntimeError, match="gather_probe_dissect kernel launch failed"):
        D._launch(1, 0, key, key, None, queries, None, None, counts, 2, 7)
    cpu = torch.zeros((8, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        D._launch(1, 0, cpu, cpu, None, torch.zeros(5, dtype=torch.int64), None, None,
                  torch.zeros(5, dtype=torch.int32), 2, 7)
    assert D.launch_counts["gather_probe_dissect"] == before + 1 and len(calls) == 2


def test_main_runs_on_the_cpu_and_never_falls_back(monkeypatch, capsys):
    for name, value in SMALL.items():
        monkeypatch.setattr(D, name, value)
    argv = ["library", "four_per_thread"]
    result = D.main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("gather_probe_dissect on cpu")
    assert len(result["design"]) == 2 and len(result["policies"]) == 2
    assert all(len(r) == 2 for r in result["design"].values())
    assert all(len(r) == len(D.POLICIES) for r in result["policies"].values())
    assert len(lines) == 1 + 2 * 3 + 2 * (1 + len(D.POLICIES))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        D.main(argv)
    assert "--device cpu" in str(exc.value.code)


@pytest.mark.cuda
@pytest.mark.parametrize("options", range(D.ALL_OPTIONS + 1))
@pytest.mark.parametrize("name", NAMES)
def test_kernel_options_change_no_result(name, options, cuda_device):
    """Each option bit of the dissection kernel, alone or with others, gives
    the numpy loop's slots and counts."""
    case = CASES[name]
    before = D.launch_counts["gather_probe_dissect"]
    slots, counts = _variants(case, cuda_device, options)
    assert D.launch_counts["gather_probe_dissect"] == before + 2
    np.testing.assert_array_equal(slots.cpu().numpy(), case.expected_slots())
    np.testing.assert_array_equal(_u32(counts), case.expected_counts())


@pytest.mark.cuda
def test_main_runs_on_the_card(monkeypatch, capsys, cuda_device):
    for name, value in SMALL.items():
        monkeypatch.setattr(D, name, value)
    result = D.main([])
    assert set(next(iter(result["design"].values()))) == set(D.VARIANTS)
    assert capsys.readouterr().out.splitlines()[0].startswith("gather_probe_dissect on ")
