"""The node-count finalize's dissection (``scripts/finalize_dissect.py``):
its entry orders and node offsets, each variant's CPU path (the finalize's
twin) on every hazard case of ``ops/finalize_cases.py``, the launch glue on
a stand-in library, its refusals, and ``main`` on the CPU at a small size.
Jax-free, so it also runs on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_finalize_dissect.py

Tests of the CUDA kernels themselves carry the ``cuda`` marker and skip
where PyTorch sees no GPU. Tolerance 0 throughout."""
import contextlib
import types

import numpy as np
import pytest
import torch

from kmer_mapper_tpu_torch import native
from kmer_mapper_tpu_torch.ops import finalize, finalize_cases
from kmer_mapper_tpu_torch.scripts import finalize_dissect as FD

CASES = finalize_cases.cases()
#: each kernel's entry order: that of the variant that launches it
ORDER = {"plain": FD.ORDERS["plain_entry"], "csr": FD.ORDERS["csr"]}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _sorted_entries(case, order):
    counts, slot, node, freq, max_frequency, n_nodes = case.inputs("cpu")
    return counts, FD.ordered((slot, node, freq), order), max_frequency, n_nodes


@pytest.mark.parametrize("order", ["slot", "node", "entry"])
def test_orders_are_stable_permutations(order):
    counts, (slot, node, freq), _, n_nodes = _sorted_entries(CASES["random"], order)
    case = CASES["random"]
    if order == "entry":
        assert np.array_equal(slot.numpy(), case.slot)
        return
    key = case.slot if order == "slot" else case.node
    pick = np.argsort(key, kind="stable")
    for got, want in zip((slot, node, freq), (case.slot, case.node, case.frequency)):
        np.testing.assert_array_equal(got.numpy(), want[pick].astype(np.int32))


def test_node_offsets_bound_each_nodes_run():
    _, (_, node, _), _, n_nodes = _sorted_entries(CASES["random"], "node")
    off = FD.node_offsets(node, n_nodes)
    assert off.dtype == torch.int32 and off.shape == (n_nodes + 1,)
    np.testing.assert_array_equal(np.diff(off.numpy()), np.bincount(node.numpy(),
                                                                    minlength=n_nodes))
    assert int(off[0]) == 0 and int(off[-1]) == node.numel()


@pytest.mark.parametrize("variant", list(FD.KERNELS))
@pytest.mark.parametrize("name", list(CASES))
def test_variant_twin_matches_numpy(name, variant):
    """On CPU tensors every variant runs the finalize's twin, in the entry
    order it takes."""
    counts, entries, max_frequency, n_nodes = _sorted_entries(
        CASES[name], ORDER[variant])
    before = dict(FD.launch_counts)
    got = FD.node_counts_variant(counts, *entries, max_frequency, n_nodes, variant)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), CASES[name].expected())
    assert FD.launch_counts == before


def test_variant_refusals():
    counts, entries, max_frequency, n_nodes = _sorted_entries(CASES["random"], "slot")
    with pytest.raises(ValueError, match="no variant 'main'"):
        FD.node_counts_variant(counts, *entries, max_frequency, n_nodes, "main")
    with pytest.raises(ValueError, match="entry_node is torch.int64"):
        FD.node_counts_variant(counts, entries[0], entries[1].long(), entries[2],
                               max_frequency, n_nodes, "plain")


def _stand_in(monkeypatch, rc):
    calls = []
    monkeypatch.setattr(native, "library", lambda: types.SimpleNamespace(
        finalize_dissect_launch=lambda *a: calls.append(a) or rc,
        kmt_error_string=lambda rc: b"invalid argument"))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: torch.device("cuda", 0)))
    return calls


@pytest.mark.parametrize("variant", list(FD.KERNELS))
def test_launch_glue_on_a_stand_in(variant, monkeypatch):
    """The variant's kernel id, the offsets' pointer for csr only, the clamped
    bound and the device reach the library; one launch counted; a failed
    launch raises and counts nothing."""
    counts, entries, _, n_nodes = _sorted_entries(CASES["random"], ORDER[variant])
    off = torch.zeros(n_nodes + 1, dtype=torch.int32)
    calls = _stand_in(monkeypatch, 0)
    before = FD.launch_counts["finalize_dissect"]
    out = FD.node_counts_variant(counts, *entries, 10**9, n_nodes, variant,
                                 off if variant == "csr" else None)
    assert out.shape == (n_nodes,)
    ((kernel, *_, off_ptr, n, bound, _, nodes, device, stream),) = calls
    assert (kernel, n, bound, nodes, device) == (FD.KERNELS[variant], entries[0].shape[0],
                                                 1 << 16, n_nodes, 0)
    assert (off_ptr is not None) == (variant == "csr")
    assert FD.launch_counts["finalize_dissect"] == before + 1
    _stand_in(monkeypatch, 1)
    with pytest.raises(RuntimeError, match="finalize_dissect kernel launch failed: invalid"):
        FD.node_counts_variant(counts, *entries, 1000, n_nodes, variant, off)
    assert FD.launch_counts["finalize_dissect"] == before + 1


def test_main_on_the_cpu(monkeypatch, capsys):
    """``main`` on the CPU (the twins) at a small library shape: every
    variant on every input, equal to the twin, one line an input."""
    monkeypatch.setattr(FD, "N_ENTRIES", 3000)
    monkeypatch.setattr(FD, "N_SLOTS", 1 << 13)
    monkeypatch.setattr(FD, "N_NODES", 4000)
    result = FD.main(["--device", "cpu"])
    assert set(result) == {"library call", "one_node", "two_hot_nodes"}
    assert all(set(t) == set(FD.ORDERS) for t in result.values())
    assert capsys.readouterr().out.count("finalize_dissect (") == 3
    assert (set(FD.main(["plain_entry", "csr", "--device", "cpu"])["one_node"])
            == {"plain_entry", "csr"})


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(FD.KERNELS))
@pytest.mark.parametrize("name", list(CASES))
def test_variant_kernel_matches_twin(name, variant, cuda_device):
    """Each variant's kernel == the finalize's twin == numpy, bit for bit,
    on every hazard case in its own entry order."""
    case = CASES[name]
    counts, slot, node, freq, max_frequency, n_nodes = case.inputs(cuda_device)
    entries = FD.ordered((slot, node, freq), ORDER[variant])
    got = FD.node_counts_variant(counts, *entries, max_frequency, n_nodes, variant)
    torch.cuda.synchronize()
    twin = finalize.finalize_reference(counts, slot, node, freq, max_frequency, n_nodes)
    assert torch.equal(got, twin)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32), case.expected())
