"""The dissection kernels of ``kmer_mapper_tpu_torch.scripts`` and their
plain twins, without jax: every kernel variant's twin against a numpy loop
over queries (the variants the Pallas scripts leave undefined included),
the flat tile schedule against a numpy loop, the wrappers' refusals and
counters, and each script's ``main`` at a small size on the CPU. It also
runs on the GPU machine, which has no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_dissect_kernels.py

Tests of the CUDA kernels themselves carry the ``cuda`` marker and skip
where PyTorch sees no GPU."""
import numpy as np
import pytest
import torch

from kmer_mapper_tpu_torch.index import layout
from kmer_mapper_tpu_torch.ops import stream_probe
from kmer_mapper_tpu_torch.ops.stream_count_cases import Case
from kmer_mapper_tpu_torch.ops.u32hash import bucket_from_mlo
from kmer_mapper_tpu_torch.scripts import r2_kernel_dissect, r2_window_dissect, r3_iter_floor

A, B, C = r2_kernel_dissect, r2_window_dissect, r3_iter_floor


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def make_case(poly: int = 600, n_buckets: int = 1024, n_keys: int = 5000,
              seed: int = 11) -> Case:
    """A chained 1024-bucket table, hits, misses, invalid queries and a
    ``poly``-query window in one chain block."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 1 << 62, n_keys, dtype=np.uint64))
    table = layout.build_table(keys, n_buckets=n_buckets)
    queries = np.concatenate([rng.choice(keys, 1500), np.full(poly, keys[3]),
                              rng.integers(0, 1 << 62, 500, dtype=np.uint64)])
    valid = rng.random(len(queries)) < 0.9
    counts0 = rng.integers(0, 1 << 32, table.n_slots, dtype=np.int64).astype(np.uint32)
    return Case("dissect", table, queries, valid, counts0)


CASE = make_case()


def loop_count(case: Case, kernel_variant: str) -> np.ndarray:
    """Each kernel variant's counts, one query and one round at a time."""
    key_lo, key_hi, _, keys, off, block_probe, _, bpb = case.inputs("cpu")
    t = case.table
    slot_lo, slot_hi = t.key_lo.reshape(-1), t.key_hi.reshape(-1)
    m_lo, m_hi = (w.numpy() for w in stream_probe.split_key(keys))
    off, block_probe = off.numpy(), block_probe.numpy()
    counts = case.counts0.astype(np.int64)
    if kernel_variant in ("empty", "empty_notb"):
        return counts.astype(np.uint32)
    tile = bpb * 8
    for b in range(len(block_probe)):
        rounds = max(1, min(int(block_probe[b]), t.max_probe))
        for i in range(off[b], off[b + 1]):
            lo, hi = int(m_lo[i]), int(m_hi[i])
            if kernel_variant == "nodma":  # the key of slot i mod tile stands in
                s = b * tile + i % tile
                lo, hi = int(slot_lo[s]), int(slot_hi[s])
            if lo == hi == 0xFFFFFFFF:
                continue
            local = int(bucket_from_mlo(np.uint32(lo), t.n_buckets)) - b * bpb
            if not 0 <= local < bpb:
                continue
            for p in range(rounds):
                bucket = b * bpb + {"nohot": p, "nomm1": local}.get(
                    kernel_variant, local + p) % bpb
                for lane in range(8):
                    if kernel_variant in ("nomm1", "nomm1_rolled"):
                        counts[bucket * 8 + lane] += 1
                    elif t.key_lo[bucket, lane] == lo and t.key_hi[bucket, lane] == hi:
                        dst = b * bpb if kernel_variant == "nomm2" else bucket
                        counts[dst * 8 + lane] += 1
    return (counts & 0xFFFFFFFF).astype(np.uint32)


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("kernel_variant", list(A.KERNEL_IDS))
def test_twin_matches_numpy_loop(kernel_variant):
    got = A.variant_twin(*CASE.inputs("cpu")[:6], min(128, CASE.table.n_buckets),
                         CASE.table.max_probe, kernel_variant)
    np.testing.assert_array_equal(_u32(got), loop_count(CASE, kernel_variant))


HAZARDS = {case.name: case for case in A.hazard_cases()}


@pytest.mark.parametrize("kernel_variant", list(A.KERNEL_IDS))
@pytest.mark.parametrize("name", list(HAZARDS))
def test_twin_matches_numpy_loop_on_hazard_cases(name, kernel_variant):
    """The tables the TPU grid takes, each with empty (all-ones) slots, and
    buckets whose 8 lanes hold one key: nodma's stand-in queries include the
    empty slots' all-ones pair, and a query of a one-key bucket hits 8
    slots."""
    case = HAZARDS[name]
    got = A.variant_twin(*case.inputs("cpu")[:6], min(128, case.table.n_buckets),
                         case.table.max_probe, kernel_variant)
    np.testing.assert_array_equal(_u32(got), loop_count(case, kernel_variant))


def test_hazard_cases_hold_empty_slots_and_one_key_buckets():
    for case in HAZARDS.values():
        n_blocks = case.table.n_buckets // min(128, case.table.n_buckets)
        assert n_blocks % A.COARSE == 0
        assert ((case.table.key_lo == 0xFFFFFFFF) & (case.table.key_hi == 0xFFFFFFFF)).any()
    case = HAZARDS["one_key_buckets"]
    full = _u32(A.stream_count_v(*case.inputs("cpu"), case.table.max_probe, "full"))
    changed = (full != case.counts0).reshape(-1, 8)
    assert changed[::2].all(axis=1).any() and not changed[1::2].all(axis=1).any()


@pytest.mark.parametrize("module", [A, B])
def test_script_variants_run_their_kernel_variants(module):
    for variant, kernel_variant in module.VARIANTS.items():
        got = module.stream_count_v(*CASE.inputs("cpu"), CASE.table.max_probe, variant)
        np.testing.assert_array_equal(_u32(got), loop_count(CASE, kernel_variant))
    np.testing.assert_array_equal(
        _u32(module.stream_count_v(*CASE.inputs("cpu"), CASE.table.max_probe, "full")),
        CASE.expected())


def ranges_loop(off, n_queries, span):
    """The schedule of window ranges, one window at a time: (block, first
    position) of each range, then (n_blocks, off[-1]) up to the bound."""
    rows = [(g, first) for g in range(len(off) - 1)
            for first in range(int(off[g]), int(off[g + 1]), span)]
    n_blocks = len(off) - 1
    rows += [(n_blocks, int(off[-1]))] * (B.n_ranges_bound(n_queries, n_blocks, span) - len(rows))
    return np.array(rows, np.int64).reshape(-1, 2)


def check_ranges(ranges, off, span):
    """Every position of every window covered once, no range crosses its
    window or holds more than ``span`` positions, the rows past the last
    range marked."""
    n_blocks = len(off) - 1
    live = ranges[:, 0] < n_blocks
    n_live = int(live.sum())
    assert live[:n_live].all()
    np.testing.assert_array_equal(ranges[n_live:], [[n_blocks, off[-1]]] * (len(ranges) - n_live))
    covered = np.zeros(int(off[-1]), np.int64)
    for g, first in ranges[:n_live]:
        last = min(first + span, int(off[g + 1]))
        assert off[g] <= first < last <= off[g + 1]
        covered[first:last] += 1
    np.testing.assert_array_equal(covered[int(off[0]):], 1)


@pytest.mark.parametrize("cap", [128, 256, 1024])
def test_tile_schedule_matches_numpy_loop_and_covers_every_query(cap):
    """The window ranges (``cap`` is the span) on random windows with two
    empty ones and a poly-A one."""
    rng = np.random.default_rng(cap)
    n_blocks = 16
    lengths = rng.integers(0, 3 * cap, n_blocks)
    lengths[[2, 9]] = 0  # empty windows
    lengths[5] = 20 * cap + 77  # a poly-A window
    off = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    n = int(off[-1]) + 5  # an invalid tail past the last window
    ranges = B.window_ranges(torch.from_numpy(off), n, cap).numpy().astype(np.int64)
    assert len(ranges) == B.n_ranges_bound(n, n_blocks, cap)
    np.testing.assert_array_equal(ranges, ranges_loop(off, n, cap))
    check_ranges(ranges, off, cap)


def edge_windows(kind: str, span: int):
    """(off, n_queries) of one schedule edge case."""
    if kind == "small_bpb":  # a 64-bucket table: one chain block of 64 buckets
        case = make_case(poly=3 * span, n_buckets=64, n_keys=300)
        off = case.inputs("cpu")[4].numpy()
        assert len(off) == 2 and case.table.n_buckets == 64
        return off, len(case.queries)
    if kind == "many_windows":  # more windows than the schedule kernel stages at once
        lengths = np.random.default_rng(span).integers(0, 3, 20_000) * (span // 2)
        lengths[[0, 9000, 19_999]] = [3 * span + 1, 0, span]
        off = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
        return off, int(off[-1])
    lengths = {
        "empty": [0, span, 0, 0, 3, 0],
        "span": [span] * 4 + [1, span],
        "span_plus_one": [span + 1, 1, span + 1, span - 1],
        "poly_a": [5, 40 * span + 7, 0, span + 1, 2],
    }[kind]
    off = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    return off, int(off[-1]) + span // 2


EDGES = ["empty", "span", "span_plus_one", "poly_a", "small_bpb", "many_windows"]


@pytest.mark.parametrize("span", [128, 1024])
@pytest.mark.parametrize("kind", EDGES)
def test_window_ranges_on_edge_windows(kind, span):
    off, n = edge_windows(kind, span)
    ranges = B.window_ranges(torch.from_numpy(off), n, span).numpy().astype(np.int64)
    np.testing.assert_array_equal(ranges, ranges_loop(off, n, span))
    check_ranges(ranges, off, span)
    lengths = np.diff(off.astype(np.int64))
    assert (ranges[:, 0] < len(lengths)).sum() == sum(-(-lengths // span))


def test_window_ranges_refuse_short_spans_and_other_devices():
    off = torch.tensor([0, 5, 9], dtype=torch.int32)
    with pytest.raises(ValueError, match="span"):
        B.window_ranges(off, 9, B.MIN_SPAN - 1)
    with pytest.raises(ValueError, match="no kernel"):
        B.window_ranges(off.to("meta"), 9)
    with pytest.raises(ValueError, match="int32"):
        B.window_ranges(off.long(), 9)


@pytest.mark.parametrize("module", [A, B])
def test_refuses_tables_the_tpu_grid_would_cut(module):
    case = make_case(n_buckets=512, n_keys=1000)  # 4 chain blocks
    assert case.table.n_buckets == 512
    with pytest.raises(ValueError, match="not a multiple of 8"):
        module.stream_count_v(*case.inputs("cpu"), case.table.max_probe, "full")


@pytest.mark.parametrize("module,name", [(A, "r2_kernel_dissect"), (B, "r2_window_dissect")])
def test_cpu_tensors_run_the_twin_and_other_devices_raise(module, name):
    before = dict(module.launch_counts)
    module.stream_count_v(*CASE.inputs("cpu"), CASE.table.max_probe, "full")
    assert module.launch_counts[name] == before[name]
    assert module.launch_counts[f"{name}_reference"] == before[f"{name}_reference"] + 1
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in CASE.inputs("cpu")]
    with pytest.raises(ValueError, match="no kernel"):
        module.stream_count_v(*meta, CASE.table.max_probe, "full")
    with pytest.raises(ValueError, match="unknown variant"):
        module.stream_count_v(*CASE.inputs("cpu"), CASE.table.max_probe, "nomm3")


def iter_floor_loop(off, tb, q, variant, n_iter, cap):
    """The stand-in variants of r3_iter_floor, one iteration and lane at a
    time: vmem and mm read tile t % 4, where dma and full read t % 64."""
    out = np.zeros((128, 8), np.float32)
    q = q.view(np.uint32)
    carry = 0
    acc0 = np.zeros(cap, np.float32)
    counts = np.zeros((128, 8), np.int64)
    bf16 = torch.from_numpy(tb).to(torch.bfloat16).to(torch.float32).numpy()
    for t in range(n_iter):
        a, b = int(off[t % 8192]), int(off[8192 + t % 8192])
        carry += a + b
        col0 = (t % 4) * cap
        for lane in range(cap):
            q0 = int(np.int32(q[0, col0 + lane].view(np.int32)))
            if variant == "vmem":
                acc0[lane] = np.float32(acc0[lane] + np.float32(q0))
                continue
            pos, local = (t % 64) * cap + lane, q0 - b % 997
            if not (a <= pos < a + cap and 0 <= local < 128):
                continue
            words = (int(q[1, col0 + lane]), int(q[2, col0 + lane]))
            for k in range(8):
                if all(bf16[local, p * 8 + k] == (words[p // 4] >> (8 * (p % 4))) & 0xFF
                       for p in range(8)):
                    counts[local, k] += 1
    out[0] = np.float32(np.int64(carry).astype(np.int32))
    if variant == "vmem":
        out[1] = acc0[:8]
    else:
        out[1:] = counts[:127]
    return out


@pytest.mark.parametrize("variant", C.STAND_INS)
def test_iter_floor_stand_ins_match_numpy_loop(variant):
    cap, n_iter = 64, 24
    off, tb, q = C.make_inputs("cpu", cap, seed=2)
    got = C.iter_floor(off, tb, q, variant, n_iter, 2, cap).numpy()
    expect = iter_floor_loop(off.numpy(), tb.numpy(), q.numpy(), variant, n_iter, cap)
    np.testing.assert_array_equal(got.view(np.uint32), expect.view(np.uint32))
    if variant == "mm":
        assert got[1:].sum() > 0


def test_iter_floor_checks_its_arguments():
    off, tb, q = C.make_inputs("cpu", 64)
    with pytest.raises(ValueError, match="unknown variant"):
        C.iter_floor(off, tb, q, "mm2", 4, 2, 64)
    with pytest.raises(ValueError, match="expected"):
        C.iter_floor(off[:-1], tb, q, "loop", 4, 2, 64)
    with pytest.raises(ValueError, match="cap"):
        C.iter_floor(off, tb, q[:, :-64].contiguous(), "loop", 4, 2, 63)
    meta = [x.to("meta") for x in (off, tb, q)]
    with pytest.raises(ValueError, match="no kernel"):
        C.iter_floor(*meta, "loop", 4, 2, 64)


#: each script's sizes, cut for the CPU
SMALL = {
    A: {"N_KEYS": 5000, "N_QUERIES": 3000},
    B: {"BUF": 32768, "STEPS": 2, "INDEX_UNIFORM": 3000, "INDEX_FROM_READS": 3000},
    C: {"CAP": 64, "N_ITER": 16, "N_GRID": 2},
}


@pytest.mark.parametrize("module", [A, B, C])
def test_main_runs_on_the_cpu_and_never_falls_back(module, monkeypatch, capsys):
    for name, value in SMALL[module].items():
        monkeypatch.setattr(module, name, value)
    argv = ["full"]
    result = module.main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"{module.__name__.rsplit('.', 1)[1]} on cpu")
    assert len(lines) == 1 + len(next(iter(result.values())))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        module.main(argv)
    assert "--device cpu" in str(exc.value.code)


def _cuda_case_args(case, device):
    return case.inputs(device), case.table.max_probe


@pytest.mark.cuda
@pytest.mark.parametrize("module,name", [(A, "r2_kernel_dissect"), (B, "r2_window_dissect")])
def test_r2_kernels_match_their_twins(module, name, cuda_device):
    case = make_case(poly=20_000)
    for variant in module.VARIANTS:
        before = module.launch_counts[name]
        got = module.stream_count_v(*case.inputs(cuda_device), case.table.max_probe, variant)
        torch.cuda.synchronize()
        assert module.launch_counts[name] == before + 1
        twin = module.stream_count_v_reference(*case.inputs(cuda_device),
                                               case.table.max_probe, variant)
        np.testing.assert_array_equal(_u32(got), _u32(twin), err_msg=variant)
    full = module.stream_count_v(*case.inputs(cuda_device), case.table.max_probe, "full")
    np.testing.assert_array_equal(_u32(full), case.expected())
    np.testing.assert_array_equal(
        _u32(full), _u32(stream_probe.stream_count(*case.inputs(cuda_device))))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(HAZARDS))
@pytest.mark.parametrize("module,kernel", [(A, "r2_kernel_dissect"), (B, "r2_window_dissect")])
def test_r2_kernels_match_their_twins_on_hazard_cases(module, kernel, name, cuda_device):
    """Every variant == its twin on each hazard case the TPU grid takes;
    full == stream_count, and == the oracle where the case has one."""
    case = HAZARDS[name]
    for variant in module.VARIANTS:
        got = module.stream_count_v(*case.inputs(cuda_device), case.table.max_probe, variant)
        twin = module.stream_count_v_reference(*case.inputs(cuda_device),
                                               case.table.max_probe, variant)
        np.testing.assert_array_equal(_u32(got), _u32(twin), err_msg=variant)
    full = module.stream_count_v(*case.inputs(cuda_device), case.table.max_probe, "full")
    np.testing.assert_array_equal(
        _u32(full), _u32(stream_probe.stream_count(*case.inputs(cuda_device))))
    if name != "one_key_buckets":
        np.testing.assert_array_equal(_u32(full), case.expected())


@pytest.mark.cuda
def test_kernel_dissect_refuses_misaligned_keys(cuda_device):
    args = list(CASE.inputs(cuda_device))
    shifted = torch.empty(args[0].numel() + 1, dtype=torch.int32, device=cuda_device)
    args[0] = shifted[1:].view(args[0].shape).copy_(args[0])
    before = A.launch_counts["r2_kernel_dissect"]
    with pytest.raises(ValueError, match="16 bytes"):
        A.stream_count_v(*args, CASE.table.max_probe, "full")
    assert A.launch_counts["r2_kernel_dissect"] == before


def near_one_inputs(device, cap: int):
    """make_inputs with every query byte 1 and key planes that bf16 rounds
    to 1.0 (from 1.0, or from a tie below or above it), to -0.0 (never a
    byte 1) or to 1.0078125 (never a byte)."""
    off, tb, q = C.make_inputs("cpu", cap, seed=9)
    rng = np.random.default_rng(9)
    q[1:] = 0x01010101
    planes = np.float32([1.0, 1.00390625, 0.998046875])[rng.integers(0, 3, (128, 64))]
    rows, cols = np.nonzero(rng.random((128, 64)) < 0.02)
    planes[rows, cols] = rng.choice(np.float32([-0.0, np.nextafter(np.float32(1.00390625),
                                                                  np.float32(2))]), len(rows))
    return off.to(device), torch.from_numpy(planes).to(device), q.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "near_one"])
@pytest.mark.parametrize("variant", C.VARIANTS)
def test_iter_floor_kernel_matches_its_twin(variant, kind, cuda_device):
    make = C.make_inputs if kind == "dense" else near_one_inputs
    off, tb, q = make(cuda_device, 1024)
    before = C.launch_counts["r3_iter_floor"]
    got = C.iter_floor(off, tb, q, variant, 512, 64, 1024)
    torch.cuda.synchronize()
    assert C.launch_counts["r3_iter_floor"] == before + 1
    twin = C.iter_floor_reference(off, tb, q, variant, 512, 64, 1024)
    np.testing.assert_array_equal(_u32(got), _u32(twin))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", EDGES)
def test_window_ranges_kernel_matches_its_twin(kind, cuda_device):
    for span in (32, 128, 1024):
        off, n = edge_windows(kind, span)
        before = B.launch_counts["r2_window_ranges"]
        got = B.window_ranges(torch.from_numpy(off).to(cuda_device), n, span)
        assert B.launch_counts["r2_window_ranges"] == before + 1
        np.testing.assert_array_equal(
            got.cpu().numpy(), B.window_ranges_reference(torch.from_numpy(off), n, span).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("edge", ["span", "span_plus_one"])
def test_window_dissect_on_a_window_at_and_past_the_span(edge, cuda_device):
    """Every variant == its twin with the span set to the longest window's
    length L (a window of S queries) or to L - 1 (a window of S + 1), on a
    case with invalid queries (valid mask) and misses."""
    case = make_case(poly=700)
    args = case.inputs(cuda_device)
    longest = int((args[4][1:] - args[4][:-1]).max())
    span = longest if edge == "span" else longest - 1
    assert bool((args[3] == stream_probe.INVALID_KEY).any())
    for variant in B.VARIANTS:
        got = B.stream_count_v(*case.inputs(cuda_device), case.table.max_probe, variant,
                               span=span)
        twin = B.stream_count_v_reference(*case.inputs(cuda_device), case.table.max_probe,
                                          variant)
        np.testing.assert_array_equal(_u32(got), _u32(twin), err_msg=variant)


def wrapping_inputs(device, cap: int = 1024):
    """make_inputs with every b a large multiple of 997 (local_b stays q[0],
    so the tile compute still hits): the carry wraps past 2^32 within a few
    iterations."""
    off, tb, q = C.make_inputs("cpu", cap, seed=4)
    rng = np.random.default_rng(4)
    off[C.OFF_HALF:] = torch.from_numpy(
        (C.MOD * rng.integers(2_000_000, 2_150_000, C.OFF_HALF)).astype(np.int32))
    return off.to(device), tb.to(device), q.to(device)


def order_inputs(device, cap: int = 1024):
    """make_inputs with q[0] drawn from [2^25, 2^26): float32 sums of such
    values round differently when the iterations are split."""
    off, tb, q = C.make_inputs("cpu", cap, seed=6)
    rng = np.random.default_rng(6)
    q[0] = torch.from_numpy(rng.integers(1 << 25, 1 << 26, q.shape[1]).astype(np.int32))
    return off.to(device), tb.to(device), q.to(device)


def test_order_input_tells_a_split_of_t_from_the_serial_sum():
    """dma's row 1 is the serial f32 sum in t order: on ``order_inputs`` a
    sum over two halves of t differs, and the twin equals the serial sum."""
    cap, n_iter = 1024, 4097
    off, tb, q = order_inputs("cpu", cap)
    tiles = q[0].numpy().astype(np.float32).reshape(C.N_TILES, cap)[:, : C.K]
    serial = np.zeros(C.K, np.float32)
    for t in range(n_iter):
        serial = serial + tiles[t % C.N_TILES]
    halves = [np.zeros(C.K, np.float32), np.zeros(C.K, np.float32)]
    for t in range(n_iter):
        halves[t % 2] = halves[t % 2] + tiles[t % C.N_TILES]
    assert not np.array_equal(serial, halves[0] + halves[1])
    got = C.iter_floor(off, tb, q, "dma", n_iter, 2, cap)
    np.testing.assert_array_equal(got[1].numpy().view(np.uint32), serial.view(np.uint32))
    carry = wrapping_inputs("cpu", cap)[0].long()
    t = torch.arange(n_iter)
    assert int(carry[t % C.OFF_HALF].sum() + carry[C.OFF_HALF + t % C.OFF_HALF].sum()) >= 1 << 32


@pytest.mark.cuda
@pytest.mark.parametrize("n_iter", [1, 3, 63, 65, 4097])
@pytest.mark.parametrize("variant", C.VARIANTS)
def test_iter_floor_kernel_on_short_and_odd_loops(variant, n_iter, cuda_device):
    """The grid and chain splits at loop lengths around the 64 tiles, with
    a wrapping carry, and dma's order-sensitive input."""
    for make in (C.make_inputs, wrapping_inputs, order_inputs):
        off, tb, q = make(cuda_device, 1024)
        got = C.iter_floor(off, tb, q, variant, n_iter, 64, 1024)
        twin = C.iter_floor_reference(off, tb, q, variant, n_iter, 64, 1024)
        np.testing.assert_array_equal(_u32(got), _u32(twin), err_msg=make.__name__)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [32, 96, 288])
def test_iter_floor_kernel_at_other_tile_widths(cap, cuda_device):
    off, tb, q = C.make_inputs(cuda_device, cap, seed=cap)
    for variant in C.VARIANTS:
        got = C.iter_floor(off, tb, q, variant, 200, 8, cap)
        np.testing.assert_array_equal(
            _u32(got), _u32(C.iter_floor_reference(off, tb, q, variant, 200, 8, cap)),
            err_msg=variant)
