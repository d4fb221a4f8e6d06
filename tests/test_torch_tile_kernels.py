"""The r9 tile-body kernels of ``kmer_mapper_tpu_torch.scripts``
(``r9_dot_orient``, ``r9_step_parts``, ``r9_block_pipeline``) and their
plain twins, without jax: every variant's twin against a numpy loop over
steps, tiles, lanes and key lanes, the layouts against each other, the
wrappers' refusals and counters, and each script's ``main`` at a small size
on the CPU. It also runs on the GPU machine, which has no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tile_kernels.py

Tests of the CUDA kernels themselves carry the ``cuda`` marker and skip
where PyTorch sees no GPU."""
import numpy as np
import pytest
import torch

from kmer_mapper_tpu_torch.scripts import r9_block_pipeline as P
from kmer_mapper_tpu_torch.scripts import r9_dot_orient as D
from kmer_mapper_tpu_torch.scripts import r9_step_parts as S

GPB, K = D.GPB, D.K
f32 = np.float32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


def lane(l, t, c):
    """(bucket, live) of lane l in tile t at step c."""
    return (37 * l + t + c) & (GPB - 1), l >= (t & 63)


def dot_orient_loop(tb, q, variant, iters):
    """The variant's count tile, one tile, lane and key lane at a time,
    with the float32 packing of the planes in numpy float32."""
    tb_bm, count_bm = D.LAYOUTS[variant]
    planes = tb.T if tb_bm else tb  # (64, 128): row p*8+k
    counts = np.zeros((K, GPB), np.int64)
    for l in range(q.shape[1]):
        lo, hi = int(q[0, l]), int(q[1, l])
        qp = (f32(lo & 0xFFFFFF), f32((lo >> 24) | ((hi & 0xFFFF) << 8)), f32(hi >> 16))
        for i in range(iters):
            b, live = lane(l, i, 0)
            if not live:
                continue
            for k in range(K):
                g = [f32(planes[p * K + k, b]) for p in range(8)]
                gp = (g[0] + f32(256) * g[1] + f32(65536) * g[2],
                      g[3] + f32(256) * g[4] + f32(65536) * g[5], g[6] + f32(256) * g[7])
                counts[k, b] += gp == qp
    counts = counts.T if count_bm else counts
    return counts.astype(np.uint32)


def steps_loop(key_lo, key_hi, counts_in, q, flags, grid, tiles):
    """The step kernels' result, one step, tile, lane and key lane at a
    time: without OWN_BLOCKS every step starts again from counts_in and
    only the last one's counts are kept."""
    def plane(x):  # (group, key lane, bucket)
        x = x.astype(np.int64)
        return x.reshape(-1, GPB, K).transpose(0, 2, 1) if flags & S.BUCKET_MAJOR else x
    klo, khi, cin = plane(key_lo), plane(key_hi), plane(counts_in)
    out = cin.copy()
    for c in range(grid):
        base = c * S.COARSE if flags & S.OWN_BLOCKS else 0
        block = cin[base : base + S.COARSE].copy()
        for t in range(tiles):
            g = (t * 7 + c) % S.COARSE
            g_tb = 0 if flags & S.TB_STATIC else g
            g_cnt = 0 if flags & S.RMW_STATIC else g
            for l in range(q.shape[1]):
                b, live = lane(l, t, c)
                for k in range(K):
                    if live and klo[base + g_tb, k, b] == q[0, l] and khi[base + g_tb, k, b] == q[1, l]:
                        block[g_cnt, k, b] += 1
        out[base : base + S.COARSE] = block
    out = out & 0xFFFFFFFF
    if flags & S.BUCKET_MAJOR:
        out = out.transpose(0, 2, 1).reshape(-1, K)
    return out.astype(np.uint32)


@pytest.mark.parametrize("variant", D.VARIANTS)
def test_dot_orient_twin_matches_numpy_loop(variant):
    tb, q = D.make_inputs("cpu", variant, lanes=64, seed=3)
    got = D.dot_orient(tb, q, variant, iters=6)
    expect = dot_orient_loop(tb.to(torch.float32).numpy(), _u32(q), variant, 6)
    np.testing.assert_array_equal(_u32(got), expect)
    assert expect.sum() > 0


STEP_CASES = ([(S, v, S.FLAGS[v], S.COARSE) for v in S.VARIANTS]
              + [(P, v, P.FLAGS[v], 3 * S.COARSE) for v in P.VARIANTS])


@pytest.mark.parametrize("module,variant,flags,n_groups", STEP_CASES)
def test_step_twins_match_numpy_loop(module, variant, flags, n_groups):
    args = S.make_step_inputs("cpu", flags, n_groups, 64, seed=4)
    fn = S.step_parts if module is S else P.block_pipeline
    got = fn(*args, variant, 3, 2)
    expect = steps_loop(*(_u32(a) for a in args), flags, 3, 2)
    np.testing.assert_array_equal(_u32(got), expect)
    assert (expect != _u32(args[2])).any()


def test_layouts_count_the_same_hits():
    """The same keys give the same counts in every layout."""
    tiles = [D.dot_orient(*D.make_inputs("cpu", v, lanes=128), v, iters=4) for v in D.VARIANTS]
    for v, t in zip(D.VARIANTS, tiles):
        np.testing.assert_array_equal(_u32(t.T if D.LAYOUTS[v][1] else t), _u32(tiles[1]))
    for fn, (plane, flat), n_groups in ((S.step_parts, ("newfull", "oldfull"), S.COARSE),
                                        (P.block_pipeline, ("new", "old"), 3 * S.COARSE)):
        module = S if fn is S.step_parts else P
        a, b = (fn(*S.make_step_inputs("cpu", module.FLAGS[v], n_groups, 128, seed=5), v, 3, 4)
                for v in (plane, flat))
        np.testing.assert_array_equal(_u32(a.transpose(1, 2).reshape(-1, K)), _u32(b))


def test_wrappers_check_their_arguments():
    tb, q = D.make_inputs("cpu", "new", lanes=64)
    with pytest.raises(ValueError, match="unknown variant"):
        D.dot_orient(tb, q, "d3old", 2)
    with pytest.raises(ValueError, match="expected"):
        D.dot_orient(tb, q, "old", 2)  # old takes the (128, 64) tile
    with pytest.raises(ValueError, match="expected"):
        D.dot_orient(tb.to(torch.float32), q, "new", 2)
    with pytest.raises(ValueError, match="iters"):
        D.dot_orient(tb, q, "new", 0)
    with pytest.raises(ValueError, match="no kernel"):
        D.dot_orient(tb.to("meta"), q.to("meta"), "new", 2)
    args = S.make_inputs("cpu", "newfull", lanes=64)
    with pytest.raises(ValueError, match="unknown variant"):
        S.step_parts(*args, "new", 3, 2)
    with pytest.raises(ValueError, match="expected"):
        S.step_parts(*args, "oldfull", 3, 2)  # oldfull takes (2048, 8)
    with pytest.raises(ValueError, match="grid"):
        S.step_parts(*args, "newfull", 0, 2)
    with pytest.raises(ValueError, match="no kernel"):
        S.step_parts(*(a.to("meta") for a in args), "newfull", 3, 2)
    with pytest.raises(ValueError, match="expected"):
        P.block_pipeline(*args, "new", 3, 2)  # 16 groups, not 48
    args = S.make_step_inputs("cpu", P.FLAGS["new"], 2 * S.COARSE, 64)
    with pytest.raises(ValueError, match="contiguous"):
        P.block_pipeline(*args[:3], args[3].T.contiguous().T, "new", 2, 2)
    with pytest.raises(ValueError, match="no kernel"):
        P.block_pipeline(*(a.to("meta") for a in args), "new", 2, 2)


@pytest.mark.parametrize("module,fn,inputs", [
    (D, "dot_orient", lambda: (*D.make_inputs("cpu", "new", lanes=64), "new", 2)),
    (S, "step_parts", lambda: (*S.make_inputs("cpu", "newfull", lanes=64), "newfull", 2, 2)),
    (P, "block_pipeline", lambda: (*S.make_step_inputs("cpu", P.FLAGS["new"], 2 * S.COARSE, 64),
                                   "new", 2, 2)),
])
def test_cpu_tensors_run_the_twin(module, fn, inputs):
    name = module.__name__.rsplit(".", 1)[1]
    before = dict(module.launch_counts)
    getattr(module, fn)(*inputs())
    assert module.launch_counts[name] == before[name]
    assert module.launch_counts[f"{name}_reference"] == before[f"{name}_reference"] + 1


#: each script's sizes, cut for the CPU
SMALL = {
    D: {"ITERS": 4, "LANES": 64},
    S: {"GRID": 3, "TILES": 2, "LANES": 64},
    P: {"GRID": 2, "TILES": 2, "LANES": 64},
}


@pytest.mark.parametrize("module", [D, S, P])
def test_main_runs_on_the_cpu_and_never_falls_back(module, monkeypatch, capsys):
    for name, value in SMALL[module].items():
        monkeypatch.setattr(module, name, value)
    result = module.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"{module.__name__.rsplit('.', 1)[1]} on cpu")
    assert len(lines) == 1 + len(module.VARIANTS) == 1 + len(result["ms"])
    assert all(line.split()[0] in module.VARIANTS and "ns per tile" in line for line in lines[1:])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        module.main([module.VARIANTS[0]])
    assert "--device cpu" in str(exc.value.code)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [7168, 1000])
@pytest.mark.parametrize("variant", D.VARIANTS)
def test_dot_orient_kernel_matches_its_twin(variant, lanes, cuda_device):
    tb, q = D.make_inputs(cuda_device, variant, lanes)
    before = D.launch_counts["r9_dot_orient"]
    got = D.dot_orient(tb, q, variant, 100)
    torch.cuda.synchronize()
    assert D.launch_counts["r9_dot_orient"] == before + 1
    twin = D.dot_orient_reference(tb, q, variant, 100)
    np.testing.assert_array_equal(_u32(got), _u32(twin))
    assert _u32(got).sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [7168, 1000])
@pytest.mark.parametrize("module,variant,flags,n_groups", [
    (S, v, f, 16) for v, f in S.FLAGS.items()] + [(P, v, f, 16 * 300) for v, f in P.FLAGS.items()])
def test_step_kernels_match_their_twins(module, variant, flags, n_groups, lanes, cuda_device):
    """300 steps: more than one per SM, so each persistent CTA runs several."""
    args = S.make_step_inputs(cuda_device, flags, n_groups, lanes)
    name = module.__name__.rsplit(".", 1)[1]
    kernel, twin = (getattr(module, name[3:]), getattr(module, f"{name[3:]}_reference"))
    before = module.launch_counts[name]
    got = kernel(*args, variant, 300, 18)
    torch.cuda.synchronize()
    assert module.launch_counts[name] == before + 1
    np.testing.assert_array_equal(_u32(got), _u32(twin(*args, variant, 300, 18)))
    assert (_u32(got) != _u32(args[2])).any()
