"""The CUDA kernels against their plain versions, on the card: the
decision-window kernel (fused.py), also behind the table's by-id entry
points and behind the native RESP transport's driver thread, and the row
gather/scatter (row_ops.py, also through a composed by-id scan and the
snapshot's save and restore), and the insight tier's device ops
(kernel.insight_topk / insight_decay) against their CPU runs, and the
tier-ladder campaign's alternation (tools/fuzz_wire_tiers.py): the kernel
beside its plain version, both against the scalar oracle; and the
launch-cost profile (tools/profile_launch.py: its first window against
the cpu run, its launches against its own count) and the replay gate
(tools/replay_determinism.py) on the card.

Needs a CUDA card: the tests carry the `cuda` marker and skip elsewhere
(decided in a fixture when they run).  The file imports nothing of jax,
so it runs where only the port is installed:

    python -m pytest tests/test_torch_card.py --noconftest -q

Tolerance: exact equality (integer arithmetic) on valid-lane outputs,
real-slot state, gathered and scattered rows, the expired-hit counts,
and every byte the native RESP transport answers.
"""

import asyncio
import socket
import threading

import numpy as np
import pytest
import torch

from throttlecrab_tpu_torch.server import native_redis
from throttlecrab_tpu_torch.server.metrics import Metrics
from throttlecrab_tpu_torch.tools import fuzz_wire_tiers as fz
from throttlecrab_tpu_torch.tpu import fused, kernel, row_ops, snapshot
from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter
from throttlecrab_tpu_torch.tpu.table import BucketTable
from torch_windows import (
    ALL_TIERS,
    NS,
    byid_words,
    cross_block_windows,
    fresh_state,
    out_mask,
    rand_window,
)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip (README)")
    return torch.device("cuda")


# (K, B): batch widths from one lane to the largest the table's scratch
# tail takes — one partial block (255), a full cluster (4096), one lane
# past it (4097: two rounds per thread), 65,536 (16 rounds).
_SHAPES = [(4, 256)] + [(K, B) for B in (1, 255, 4096, 4097, 65536)
                        for K in (1, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("K,B", _SHAPES)
def test_kernel_matches_plain_version_on_card(cuda_device, K, B):
    """Every tier and width: two hostile windows, then the cross-block
    windows (one slot over every lane of every sub-batch; one slot at
    lanes 0 and B-1 of every sub-batch), state carried across all four.
    Each window is exactly one launch."""
    cap = max(512, 2 * B)
    for width in (4, 6):
        for t, (compact, with_degen) in enumerate(ALL_TIERS):
            rng = np.random.default_rng(100 * width + 10 * t + K)
            st_k = torch.from_numpy(fresh_state(cap + B, width)).to(
                cuda_device
            )
            st_p = st_k.clone()
            windows = [rand_window(rng, K, B, cap, with_degen)
                       for _ in range(2)]
            windows += cross_block_windows(rng, K, B, cap, with_degen)
            for packed, now, valid in windows:
                p = torch.from_numpy(packed).to(cuda_device)
                n = torch.from_numpy(now).to(cuda_device)
                before = fused.LAUNCHES
                out_k, ne_k = fused.fused_window(
                    st_k, p, n, with_degen=with_degen, compact=compact
                )
                assert fused.LAUNCHES == before + 1
                out_p, ne_p = kernel.decide_window(
                    st_p, p, n, with_degen=with_degen, compact=compact
                )
                torch.cuda.synchronize()
                mask = out_mask(valid, compact)
                assert not (
                    (out_k.cpu().numpy() != out_p.cpu().numpy()) & mask
                ).any()
                assert torch.equal(st_k[:cap], st_p[:cap])
                assert torch.equal(ne_k, ne_p)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    """Wrong dtype, width or batch raises before any launch; nothing
    falls back to the plain version."""
    rng = np.random.default_rng(9)
    packed, now, _ = rand_window(rng, 1, 8, 16, True)
    p = torch.from_numpy(packed).to(cuda_device)
    n = torch.from_numpy(now).to(cuda_device)
    before = fused.LAUNCHES
    with pytest.raises(ValueError):
        fused.fused_window(torch.zeros((24, 5), dtype=torch.int32,
                                       device=cuda_device), p, n)
    with pytest.raises(TypeError):
        fused.fused_window(torch.zeros((24, 4), dtype=torch.int64,
                                       device=cuda_device), p, n)
    with pytest.raises(ValueError):
        fused.fused_window(torch.zeros((4, 4), dtype=torch.int32,
                                       device=cuda_device), p, n)
    assert fused.LAUNCHES == before
    fused.fused_window(torch.from_numpy(fresh_state(24, 4)).to(cuda_device),
                       p, n)
    assert fused.LAUNCHES == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("W", row_ops.WIDTHS)
def test_row_kernels_match_index_select_and_copy(cuda_device, W):
    """Gather and scatter against index_select / index_copy_, rows 0 and
    N-1 included, at the by-id path's batch of 4096."""
    rng = np.random.default_rng(W)
    N, B = (1 << 16) + 5, 4096
    base = torch.from_numpy(
        rng.integers(-(2**31), 2**31 - 1, (N, W)).astype(np.int32)
    ).to(cuda_device)
    idx_np = np.concatenate(
        [[0, N - 1], 1 + rng.choice(N - 2, B - 2, replace=False)]
    ).astype(np.int32)
    idx = torch.from_numpy(idx_np).to(cuda_device)
    rows = torch.from_numpy(
        rng.integers(-(2**31), 2**31 - 1, (B, W)).astype(np.int32)
    ).to(cuda_device)
    g0, s0 = row_ops.GATHER_LAUNCHES, row_ops.SCATTER_LAUNCHES
    got = row_ops.row_gather(base, idx)
    table = base.clone()
    row_ops.row_scatter(table, idx, rows)
    torch.cuda.synchronize()
    assert (row_ops.GATHER_LAUNCHES, row_ops.SCATTER_LAUNCHES) == (
        g0 + 1, s0 + 1)
    assert torch.equal(got, base.index_select(0, idx))
    want = base.clone()
    want.index_copy_(0, idx.long(), rows)
    assert torch.equal(table, want)


@pytest.mark.cuda
def test_row_kernels_reject_what_they_do_not_take(cuda_device):
    """A table off a 16-byte boundary (4 or 8 bytes, either width), the
    scatter's rows off their part (4 or 8 bytes at W=4, 4 at W=6), an
    index off the card or a wrong dtype raises before any launch."""
    table = torch.zeros((64, 4), dtype=torch.int32, device=cuda_device)
    idx = torch.arange(8, dtype=torch.int32, device=cuda_device)
    before = (row_ops.GATHER_LAUNCHES, row_ops.SCATTER_LAUNCHES)
    with pytest.raises(ValueError):
        row_ops.row_gather(table, idx.cpu())
    with pytest.raises(ValueError):  # a 4-wide view 4 bytes off alignment
        row_ops.row_gather(table.view(-1)[1:253].view(63, 4), idx)
    for w in row_ops.WIDTHS:  # 8 bytes off, at either width
        off = _dense_view((63, w), 8, cuda_device)
        with pytest.raises(ValueError):
            row_ops.row_gather(off, idx)
        with pytest.raises(ValueError):
            row_ops.row_scatter(off, idx, torch.zeros(
                (8, w), dtype=torch.int32, device=cuda_device))
    for w, offset in ((4, 4), (4, 8), (6, 4)):
        rows = _dense_view((8, w), offset, cuda_device)
        with pytest.raises(ValueError):
            row_ops.row_scatter(torch.zeros(
                (64, w), dtype=torch.int32, device=cuda_device), idx, rows)
    with pytest.raises(TypeError):
        row_ops.row_scatter(table, idx, torch.zeros(
            (8, 4), dtype=torch.int64, device=cuda_device))
    assert (row_ops.GATHER_LAUNCHES, row_ops.SCATTER_LAUNCHES) == before


def _dense_view(shape, offset, device):
    """An int32 tensor of `shape` starting `offset` bytes past a 16-byte
    boundary (a view into a larger buffer)."""
    n = int(np.prod(shape))
    raw = torch.empty(n + 4, dtype=torch.int32, device=device)
    skip = ((offset - raw.data_ptr()) % 16) // 4
    view = raw[skip:skip + n].view(shape)
    assert view.data_ptr() % 16 == offset
    return view


# The row kernels' edge batches (tests/test_torch_row_tile.py pins the
# same on the CPU): one row, a partial warp step, around 256, the by-id
# batch, the W=6 scatter's step from one row a lane to two (42,240 to
# 42,241), one short of the last whole block below 65,536 of the tile the
# largest batches pick (rows per block: 256 at W=4, 80 at W=6), at it
# and past it, 65,535 and 65,536.
_BIG_BLOCK_ROWS = {4: 256, 6: 80}
_ROW_BATCHES = [1, 2, 255, 256, 257, 4096, 42_240, 42_241, "edge-1",
                "edge", "edge+1", 65_535, 65_536]


@pytest.mark.cuda
@pytest.mark.parametrize("label", _ROW_BATCHES)
@pytest.mark.parametrize("W,offset", [(4, 0), (6, 0), (6, 8)])
def test_row_kernels_at_edge_batches_on_card(cuda_device, W, offset,
                                             label):
    """Gather and scatter through the wrappers against the plain version
    at the edge batches, first rows even and odd, the scatter's rows
    `offset` bytes past a 16-byte boundary (8 bytes: the W=6 part)."""
    b = label
    if not isinstance(label, int):
        per = _BIG_BLOCK_ROWS[W]
        b = ((1 << 16) - 1) // per * per + {"edge-1": -1, "edge": 0,
                                            "edge+1": 1}[label]
    rng = np.random.default_rng([W, b, offset])
    n = 2 * b + 67
    table = torch.from_numpy(
        rng.integers(-(2**31), 2**31 - 1, (n, W)).astype(np.int32)
    ).to(cuda_device)
    rows = _dense_view((b, W), offset, cuda_device)
    rows.copy_(torch.from_numpy(
        rng.integers(-(2**31), 2**31 - 1, (b, W)).astype(np.int32)))
    perm = rng.permutation(n).astype(np.int32)
    for first in (0, 1):
        j = int(np.flatnonzero(perm % 2 == first)[0])
        idx = torch.from_numpy(np.roll(perm, -j)[:b].copy()).to(cuda_device)
        got = row_ops.row_gather(table, idx)
        assert torch.equal(got, row_ops.row_gather_plain(table, idx))
        want = row_ops.row_scatter_plain(table.clone(), idx, rows)
        got = table.clone()
        row_ops.row_scatter(got, idx, rows)
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["-1", "N", "2^31-1"])
@pytest.mark.parametrize("W", row_ops.WIDTHS)
def test_row_kernels_outside_the_table_on_card(cuda_device, W, bad):
    """An index outside [0, N) at the first, a middle and the last row of
    4,097: the gather reads a zero row, the scatter drops the write, and
    every other row moves as the plain version moves it."""
    rng = np.random.default_rng([W, len(bad)])
    n, b = 20_011, 4097
    table = torch.from_numpy(
        rng.integers(-(2**31), 2**31 - 1, (n, W)).astype(np.int32)
    ).to(cuda_device)
    idx_np = rng.permutation(n)[:b].astype(np.int32)
    at = [0, b // 2, b - 1]
    idx_np[at] = {"-1": -1, "N": n, "2^31-1": 2**31 - 1}[bad]
    keep = torch.from_numpy(np.isin(np.arange(b), at, invert=True)).to(
        cuda_device)
    idx = torch.from_numpy(idx_np).to(cuda_device)
    rows = torch.from_numpy(
        rng.integers(-(2**31), 2**31 - 1, (b, W)).astype(np.int32)
    ).to(cuda_device)
    got = row_ops.row_gather(table, idx)
    want = torch.zeros_like(rows)
    want[keep] = row_ops.row_gather_plain(table, idx[keep])
    assert torch.equal(got, want)
    got = table.clone()
    row_ops.row_scatter(got, idx, rows)
    want = row_ops.row_scatter_plain(table.clone(), idx[keep], rows[keep])
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["ids", "ids20"])
@pytest.mark.parametrize("W", row_ops.WIDTHS)
def test_byid_scan_on_card_matches_cpu(cuda_device, W, variant):
    """gcra_scan_ids_acc / _ids20_acc on the card (rows through the
    kernels) decide as on the CPU (plain rows), 2K row launches per
    window."""
    rng = np.random.default_rng(11 + W)
    n_ids, cap, K, B = 300, 512, 4, 256
    slots = rng.choice(cap, n_ids, replace=False).astype(np.int32)
    em = rng.choice([1000, NS, 7 * NS], n_ids).astype(np.int64)
    rows = torch.from_numpy(kernel.pack_id_rows(slots, em, em * 5))
    ids = rng.integers(-1, n_ids, (K, B)).astype(np.int32)
    stream, scan = torch.from_numpy(ids), kernel.gcra_scan_ids_acc
    if variant == "ids20":
        stream = torch.from_numpy(kernel.pack_ids20(ids))
        scan = kernel.gcra_scan_ids20_acc
    now = torch.from_numpy(1_753_700_000 * NS + np.arange(K) * NS)
    outs = {}
    for dev in ("cpu", cuda_device):
        st = torch.from_numpy(fresh_state(cap + B, W)).to(dev)
        g0 = row_ops.GATHER_LAUNCHES
        st, acc, out = scan(
            st, torch.zeros((), dtype=torch.int64, device=dev),
            rows.to(dev), stream.to(dev), now.to(dev), 1,
            with_degen=False, compact="w32",
        )
        outs[str(dev)] = (st[:cap].cpu(), int(acc), out.cpu(),
                          row_ops.GATHER_LAUNCHES - g0)
    (st_c, acc_c, out_c, n_c), (st_g, acc_g, out_g, n_g) = outs.values()
    valid = torch.from_numpy(ids >= 0)
    assert n_c == 0 and n_g == K
    assert torch.equal(st_c, st_g) and acc_c == acc_g
    assert torch.equal(out_c[valid], out_g[valid])


def _byid_stream(variant, ids, slots):
    if variant == "byid":
        return byid_words(ids, slots)
    if variant == "ids20":
        return kernel.pack_ids20(ids)
    return ids


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["byid", "ids", "ids20"])
@pytest.mark.parametrize("W", row_ops.WIDTHS)
def test_byid_table_on_card_is_one_window_launch(cuda_device, W, variant):
    """check_many_{byid,ids,ids20} on the card decide as the cpu route:
    each call is exactly one fused_window launch and no row-kernel
    launch.  The windows at B = 4096 include one whose duplicate segment
    spans every lane of every sub-batch (across the cluster's blocks) and
    one with an id at lanes 0 and B-1 of every sub-batch."""
    rng = np.random.default_rng(23 + W)
    n_ids, cap, K, B = 3000, 8192, 4, 4096
    slots = rng.choice(cap, n_ids, replace=False).astype(np.int32)
    em = rng.choice([1000, NS, 7 * NS], n_ids).astype(np.int64)
    hot = int(rng.integers(0, n_ids))
    edge = rng.integers(-1, n_ids, (K, B)).astype(np.int32)
    edge[edge == hot] = (hot + 1) % n_ids
    edge[:, 0] = edge[:, -1] = hot
    windows = [rng.integers(-1, n_ids, (K, B)).astype(np.int32),
               np.full((K, B), hot, np.int32), edge]
    tiers = [("cur", False), (False, True)]
    if variant == "ids20":
        tiers = [("w32", False), (True, True)]
    results = {}
    for dev in ("cpu", cuda_device):
        table = BucketTable(cap, device=dev, insight=W > 4)
        rows = table.upload_id_rows(slots, em, em * 5)
        outs = []
        for j, ids in enumerate(windows * len(tiers)):
            compact, with_degen = tiers[j // len(windows)]
            now = 1_753_700_000 * NS + (j * K + np.arange(K)) * NS // 4
            before = (fused.LAUNCHES, row_ops.GATHER_LAUNCHES,
                      row_ops.SCATTER_LAUNCHES)
            out = getattr(table, "check_many_" + variant)(
                rows, _byid_stream(variant, ids, slots), now, 1,
                with_degen=with_degen, compact=compact,
            )
            if dev != "cpu":
                assert (fused.LAUNCHES - before[0],
                        row_ops.GATHER_LAUNCHES - before[1],
                        row_ops.SCATTER_LAUNCHES - before[2]) == (1, 0, 0)
            outs.append((out.cpu().numpy(), ids >= 0, compact))
        results[str(dev)] = (outs, table.state[:cap].cpu(),
                             table.expired_hits())
    (outs_c, st_c, hits_c), (outs_g, st_g, hits_g) = results.values()
    for (oc, valid, compact), (og, _, _) in zip(outs_c, outs_g):
        assert not ((oc != og) & out_mask(valid, compact)).any()
    assert torch.equal(st_c, st_g) and hits_c == hits_g


@pytest.mark.cuda
def test_byid_table_raises_when_the_window_kernel_cannot_launch(
    cuda_device, monkeypatch
):
    """No fallback: a by-id call whose window kernel cannot be loaded
    raises, and nothing else decides the window."""
    table = BucketTable(64, device=cuda_device)
    rows = table.upload_id_rows(np.arange(8, dtype=np.int32),
                                np.full(8, NS, np.int64),
                                np.full(8, 4 * NS, np.int64))
    state = table.state.clone()

    def broken(index):
        raise RuntimeError("window kernel unavailable")

    monkeypatch.setattr(fused, "_load", broken)
    before = (row_ops.GATHER_LAUNCHES, row_ops.SCATTER_LAUNCHES)
    with pytest.raises(RuntimeError, match="unavailable"):
        table.check_many_ids(rows, np.arange(8, dtype=np.int32)[None],
                             np.array([1_753_700_000 * NS]), 1,
                             with_degen=False, compact="cur")
    assert (row_ops.GATHER_LAUNCHES, row_ops.SCATTER_LAUNCHES) == before
    assert torch.equal(table.state, state)


# ---- the native RESP transport's driver on the card ---------------------- #

T0 = 1_753_700_000 * NS


def _resp(key, burst, count, period, *rest):
    parts = [b"THROTTLE", key, *(b"%d" % v for v in (burst, count, period,
                                                     *rest))]
    return b"*%d\r\n" % len(parts) + b"".join(
        b"$%d\r\n%s\r\n" % (len(p), p) for p in parts)


class _Recording(native_redis.NativeRedisTransport):
    """Records each window's frames, cookies, timestamp and results."""

    windows = None

    def _decide_frames(self, frames, now_ns):
        results, seq = super()._decide_frames(frames, now_ns)
        self.windows[-1].update(frames=frames, now_ns=now_ns, results=results)
        return results, seq

    def _decide_window(self, batches):
        self.windows.append({"cookies": [(b[3], b[4]) for b in batches]})
        super()._decide_window(batches)


def _serve(device, streams, capacity, cls=native_redis.NativeRedisTransport,
           **kw):
    """Serve `streams` (one bytes string per connection, sent pipelined
    from one thread each) on a native RESP transport over a limiter on
    `device` with a fixed clock; returns (transport, replies per stream).
    Each stream ends with QUIT, so a connection's replies end at close."""
    lim = TorchRateLimiter(capacity=capacity, keymap="native", device=device)
    t = cls("127.0.0.1", 0, lim, Metrics(), now_fn=lambda: T0, **kw)
    if cls is _Recording:
        t.windows = []
    out = [None] * len(streams)

    def client(i):
        with socket.create_connection(("127.0.0.1", t.bound_port), 30) as s:
            s.sendall(streams[i])
            data = b""
            while chunk := s.recv(1 << 16):
                data += chunk
            out[i] = data

    async def main():
        await t.start()
        try:
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(streams))]
            for th in threads:
                th.start()
            for th in threads:
                await asyncio.get_running_loop().run_in_executor(
                    None, th.join, 60)
        finally:
            await t.stop()

    asyncio.run(main())
    return t, out


@pytest.mark.cuda
def test_native_resp_driver_on_card_matches_cpu_replay(cuda_device):
    """Two connections pipeline 6,000 THROTTLEs over 800 keys (per-key
    params) into a driver at batch 512: each window is one decision-window
    launch on the dispatch_wire_window route, and a device="cpu" replay
    of the recorded windows gives the same results, the same table state
    and, per connection, the same reply bytes."""
    rng = np.random.default_rng(77)
    kid = rng.integers(0, 800, 6000)
    cmds = [_resp(b"card:%d" % k, 2 + k % 9, 1 + k % 50, 1 + k % 30)
            for k in kid.tolist()]
    streams = [b"".join(cmds[c::2]) + b"*1\r\n$4\r\nQUIT\r\n"
               for c in range(2)]
    before = (fused.LAUNCHES, native_redis.WIRE_WINDOWS,
              native_redis.EXACT_WINDOWS, native_redis.DISPATCH_ERRORS)
    t, got = _serve(cuda_device, streams, 4096, cls=_Recording,
                    batch_size=512, max_scan_depth=4)
    n = len(t.windows)
    assert (fused.LAUNCHES - before[0], native_redis.WIRE_WINDOWS - before[1],
            native_redis.EXACT_WINDOWS - before[2],
            native_redis.DISPATCH_ERRORS - before[3]) == (n, n, 0, 0)
    ref = TorchRateLimiter(capacity=4096, keymap="native", device="cpu")
    replies = {}
    for w in t.windows:
        want = ref.dispatch_wire_window(w["frames"], w["now_ns"]).fetch()
        for res_g, res_c, (gen, fd) in zip(w["results"], want, w["cookies"]):
            for f in ("allowed", "limit", "remaining", "reset_after_s",
                      "retry_after_s", "status"):
                assert np.array_equal(getattr(res_g, f), getattr(res_c, f))
            rows = np.stack([res_c.allowed.astype(np.int64), res_c.limit,
                             res_c.remaining, res_c.reset_after_s,
                             res_c.retry_after_s], 1).tolist()
            for cookie, row in zip(zip(gen.tolist(), fd.tolist()), rows):
                replies.setdefault(cookie, []).append(
                    b"*5\r\n:%d\r\n:%d\r\n:%d\r\n:%d\r\n:%d\r\n"
                    % tuple(row))
    want = sorted(b"".join(r) + b"+OK\r\n" for r in replies.values())
    assert sorted(got) == want
    assert torch.equal(t.limiter.table.state[:4096].cpu(),
                       ref.table.state[:4096])


@pytest.mark.cuda
def test_native_resp_exact_path_on_card_answers_as_cpu(cuda_device):
    """A window the native prep refuses (a full table, a key whose params
    change in the batch) takes the exact path on the card, and the
    transport answers the same bytes as on the CPU."""
    stream = (
        b"".join(_resp(b"f%d" % i, 2, 1, 60) for i in range(40)) * 2
        + _resp(b"c", 3, 1, 60) + _resp(b"c", 5, 1, 60)
        + _resp(b"c", 3, 1, 60, 2) + b"*1\r\n$4\r\nQUIT\r\n"
    )
    exact = native_redis.EXACT_WINDOWS
    _, got = _serve(cuda_device, [stream], 16, batch_size=64)
    assert native_redis.EXACT_WINDOWS > exact
    _, want = _serve("cpu", [stream], 16, batch_size=64)
    assert got == want and got[0].endswith(b"+OK\r\n")


@pytest.mark.cuda
@pytest.mark.parametrize("keymap", ["python", "native"])
@pytest.mark.parametrize("insight", [False, True], ids=["w4", "w6"])
def test_snapshot_round_trip_on_card(cuda_device, tmp_path, monkeypatch,
                                     keymap, insight):
    """5,000 keys saved from a cuda limiter and restored into a cuda and a
    cpu one, with MAX_BATCH cut to 1,024: five row_gather and five
    row_scatter launches; both restores hold the original's per-key
    state and the same certificates, and decide the next batch alike."""
    monkeypatch.setattr(row_ops, "MAX_BATCH", 1024)
    keys = [f"card:{i}" for i in range(5000)]
    kid = np.arange(5000, dtype=np.int64)
    params = (5 + kid % 60, 50 + kid % 1000, 30 + kid % 120, 1)
    lim = TorchRateLimiter(capacity=8192, keymap=keymap, insight=insight)
    lim.rate_limit_batch(keys, *params, T0)
    path = tmp_path / "snap"
    gathers, scatters = row_ops.GATHER_LAUNCHES, row_ops.SCATTER_LAUNCHES
    assert snapshot.save_snapshot(lim, path) == 5000
    assert row_ops.GATHER_LAUNCHES - gathers == 5
    restored = TorchRateLimiter(capacity=8192, keymap=keymap,
                                insight=insight)
    assert snapshot.load_snapshot(restored, path, T0) == 5000
    assert row_ops.SCATTER_LAUNCHES - scatters == 5
    on_cpu = TorchRateLimiter(capacity=8192, keymap=keymap, device="cpu",
                              insight=insight)
    assert snapshot.load_snapshot(on_cpu, path, T0) == 5000

    def keyed(limiter):
        ks, _, _, tat, exp, _, _ = snapshot.export_state(limiter)
        return dict(zip(ks, zip(tat.tolist(), exp.tolist())))

    want = keyed(lim)
    assert keyed(restored) == want and keyed(on_cpu) == want
    certs = [(t.cur_safe, t.tol_hwm, t.now_hwm)
             for t in (restored.table, on_cpu.table)]
    assert certs[0] == certs[1]
    assert torch.equal(restored.table.state[:8192].cpu(),
                       on_cpu.table.state[:8192])
    got = restored.rate_limit_batch(keys, *params, T0 + NS)
    ref = on_cpu.rate_limit_batch(keys, *params, T0 + NS)
    for f in ("allowed", "limit", "remaining", "reset_after_ns",
              "retry_after_ns", "status"):
        assert np.array_equal(getattr(got, f), getattr(ref, f))


@pytest.mark.cuda
def test_snapshot_restore_of_two_keys_on_one_slot_on_card(cuda_device,
                                                           tmp_path):
    """"a" and b"a" from a python keymap both become b"a" in a native
    one: the restore on the card keeps the last row, as on the CPU (and
    as the JAX package's), and hands the kernel unique slots."""
    src = TorchRateLimiter(capacity=64, device="cpu")
    src.rate_limit_batch(["a"] + [b"a"] * 3, 5, 10, 3600, 1, T0)
    path = tmp_path / "dup"
    snapshot.save_snapshot(src, path)
    got = TorchRateLimiter(capacity=64, keymap="native")
    want = TorchRateLimiter(capacity=64, keymap="native", device="cpu")
    assert snapshot.load_snapshot(got, path, T0) == 2
    assert snapshot.load_snapshot(want, path, T0) == 2
    assert torch.equal(got.table.state[:64].cpu(), want.table.state[:64])
    _, _, _, tat, _, _, _ = snapshot.export_state(got)
    assert tat.tolist() == [snapshot.export_state(src)[3][1]]


# ---- the launch supervisor and the front tier on the card ----------------- #


def _drill_windows(rng, n_keys, n_windows, k, b):
    """Zipf-1.1 config-3 style windows over `n_keys` keys, quantity 1,
    one timestamp per window."""
    p = np.arange(1, n_keys + 1, dtype=np.float64) ** -1.1
    cdf = np.cumsum(p / p.sum())
    now, windows = T0 + NS, []
    for _ in range(n_windows):
        batches = []
        for _ in range(k):
            kid = np.minimum(np.searchsorted(cdf, rng.random(b)),
                             n_keys - 1).astype(np.int64)
            batches.append(([f"card:{i}" for i in kid.tolist()],
                            5 + kid % 60, 50 + kid % 1000, 30 + kid % 120,
                            np.ones(b, np.int64), now))
        # One timestamp per window, as the server stamps one.
        now += int(rng.integers(2_000_000, 30_000_000))
        windows.append(batches)
    return windows


@pytest.mark.cuda
def test_supervisor_drill_on_card(cuda_device, monkeypatch):
    """Phase 11a of chip_smoke.py at 5,000 keys (MAX_BATCH cut to 1,024):
    absorbed launch and fetch faults, a degrade that exports the table
    with 5 row_gather launches, two windows from the host oracle with no
    window launch, then exactly one probe launch and a re-promotion by
    ceil(mutated / 1,024) row_scatter launches.  Every result and every
    live bucket equal an uninterrupted device="cpu" run."""
    from throttlecrab_tpu_torch import faults
    from throttlecrab_tpu_torch.server import supervisor as sup_mod

    monkeypatch.setattr(row_ops, "MAX_BATCH", 1024)
    n_keys = 5000
    windows = _drill_windows(np.random.default_rng(5), n_keys, 8, 4, 256)
    windows[6:] = [[(*b[:5], b[5] + 2 * NS) for b in w] for w in windows[6:]]
    kid = np.arange(n_keys, dtype=np.int64)
    populate = ([f"card:{i}" for i in kid.tolist()], 5 + kid % 60,
                50 + kid % 1000, 30 + kid % 120, 1, T0)
    lim = TorchRateLimiter(capacity=8192)
    ref = TorchRateLimiter(capacity=8192, device="cpu")
    for limiter in (lim, ref):
        limiter.rate_limit_batch(*populate, wire=True)
    sup = sup_mod.SupervisedLimiter(lim, retries=2, sleep_fn=lambda s: None)
    seen = []

    class Probe:
        def on_restore(self):
            seen.append((fused.LAUNCHES, row_ops.SCATTER_LAUNCHES))

    sup.front = Probe()
    got = []
    try:
        for w, spec in enumerate([None, "launch:count:2", "fetch:count:1",
                                  "launch:persistent", None, None, "heal",
                                  None]):
            if spec == "heal":
                faults.disarm()
                fused.LAUNCHES = row_ops.SCATTER_LAUNCHES = 0
            elif spec is not None:
                faults.arm(faults.FaultInjector(faults.parse_spec(spec)))
            if spec == "launch:persistent":
                row_ops.GATHER_LAUNCHES = 0
            if w == 4:
                fused.LAUNCHES = 0
            got.append(sup.dispatch_many(windows[w], wire=True).fetch())
            if spec == "launch:persistent":
                assert sup.state == "degraded"
                assert row_ops.GATHER_LAUNCHES == 5
            if w == 5:
                assert fused.LAUNCHES == 0
    finally:
        faults.disarm()
    assert (sup.retry_count, sup.degrade_count, sup.repromote_count,
            sup.state) == (2 + 1 + 3, 1, 1, "ok")
    assert len(seen) == 1 and seen[0][0] == 1 and seen[0][1] >= 1
    want = [ref.dispatch_many(w, wire=True).fetch() for w in windows]
    for a_list, b_list in zip(got, want):
        for a, b in zip(a_list, b_list):
            for f in ("allowed", "limit", "remaining", "reset_after_s",
                      "retry_after_s", "status"):
                assert np.array_equal(getattr(a, f), getattr(b, f))

    def keyed(limiter):
        ks, _, _, tat, exp, _, _ = snapshot.export_state(limiter)
        return dict(zip(ks, zip(tat.tolist(), exp.tolist())))

    now = windows[-1][-1][-1]
    have, ref_state = keyed(sup), keyed(ref)
    assert have.pop(sup_mod.PROBE_KEY) is not None
    assert have.keys() == ref_state.keys()
    for key, row in ref_state.items():
        assert have[key] == row or (have[key][1] <= now and row[1] <= now)


@pytest.mark.cuda
def test_front_tier_native_resp_on_card_matches_no_front_cpu(cuda_device):
    """Phase 11b of chip_smoke.py at a small size: one pipelined
    connection of hot-key abuse into the native RESP driver over a front
    tier with the default knobs on the card answers byte for byte as a
    driver without a front tier on the CPU; the deny cache served hits
    and the card saw no more launches than windows."""
    from throttlecrab_tpu_torch.server.config import Config
    from throttlecrab_tpu_torch.server.store import create_front_tier

    rng = np.random.default_rng(8)
    kid = np.minimum(rng.zipf(1.3, 4000), 60) - 1
    stream = b"".join(_resp(b"hot:%d" % k, 2 + k % 3, 1 + k % 5, 60)
                      for k in kid.tolist()) + b"*1\r\n$4\r\nQUIT\r\n"
    metrics = Metrics()
    lim = TorchRateLimiter(capacity=4096, keymap="native")
    front = create_front_tier(Config(), metrics, lim)
    t = native_redis.NativeRedisTransport(
        "127.0.0.1", 0, lim, metrics, now_fn=lambda: T0, batch_size=256,
        front=front)
    out = []

    def client():
        with socket.create_connection(("127.0.0.1", t.bound_port), 30) as s:
            s.sendall(stream)
            data = b""
            while chunk := s.recv(1 << 16):
                data += chunk
            out.append(data)

    async def main():
        await t.start()
        try:
            th = threading.Thread(target=client)
            th.start()
            await asyncio.get_running_loop().run_in_executor(
                None, th.join, 60)
        finally:
            await t.stop()

    before = fused.LAUNCHES
    asyncio.run(main())
    launches = fused.LAUNCHES - before
    _, want = _serve("cpu", [stream], 4096, batch_size=256)
    assert out == want
    assert front.deny_cache.hits > 0
    assert 0 < launches <= metrics.device_launches


@pytest.mark.cuda
def test_serving_ab_times_this_checkout(cuda_device, monkeypatch):
    """serving_ab.py (the repo root's A/B of the RESP serving path) times
    this checkout's native RESP transport at a small size, with and
    without the default front tier, through chip_smoke.py's clients."""
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    import serving_ab

    for front in (False, True):
        assert serving_ab.resp_rate(chip_smoke, 4096, front) > 0


def _ins_state(rng, n, device):
    """i32[n, 6] insight rows whose denied counts (0..40, and a few past
    2^32) tie heavily, so the top-K boundary falls inside runs of equal
    counts."""
    counts = rng.integers(0, 41, n).astype(np.int64)
    counts[rng.integers(0, n, 64)] += 1 << 33
    tat = rng.integers(0, 1 << 62, n).astype(np.int64)
    state = torch.cat([
        kernel.pack_state(torch.from_numpy(tat), torch.from_numpy(tat + 7)),
        kernel._split_cols(torch.from_numpy(counts)),
    ], dim=-1)
    return state.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 64, 4096])
def test_insight_topk_and_decay_on_card_match_cpu(cuda_device, k):
    """insight_topk / insight_decay on the card at 2^20 rows (plus the
    scratch tail) against their CPU runs: the same counts and slot ids in
    the same order under ties, and the same halved rows."""
    cap = 1 << 20
    state = _ins_state(np.random.default_rng(k), cap + (1 << 16),
                       cuda_device)
    ref = state.cpu()
    vals, ids = kernel.insight_topk(state, capacity=cap, k=k)
    want_vals, want_ids = kernel.insight_topk(ref, capacity=cap, k=k)
    assert torch.equal(vals.cpu(), want_vals)
    assert torch.equal(ids.cpu(), want_ids)
    assert int(ids.max()) < cap
    kernel.insight_decay(state)
    kernel.insight_decay(ref)
    assert torch.equal(state.cpu(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["diurnal", "flash-crowd", "slow-drift"])
def test_replay_on_card_equals_cpu_replay(cuda_device, pattern):
    """A synthesized trace replayed on the `device` target on the card
    gives the byte-identical outcome vector of its device="cpu" replay
    (and of the outcomes the scalar oracle filled in), one window-kernel
    launch per window (every key keeps its params)."""
    from throttlecrab_tpu_torch.replay.generators import synthesize
    from throttlecrab_tpu_torch.replay.player import (
        make_target,
        outcome_vector,
        replay,
    )

    trace = synthesize(pattern, windows=12, batch=512, key_space=4096,
                       seed=3)
    before = fused.LAUNCHES
    got = outcome_vector(replay(trace, make_target("device", trace)))
    launches = fused.LAUNCHES - before
    want = outcome_vector(replay(trace, make_target("device", trace,
                                                    device="cpu")))
    assert got == want == trace.outcome_vector()
    assert launches == len(trace.windows)


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 3, 8])
def test_mesh_on_card_equals_single_device_and_cpu_shards(cuda_device,
                                                          shards):
    """chip_smoke.py phase 15's identity at a small size: a mesh of
    `shards` slices of the card decides tenant traffic (K-deep windows
    through dispatch_many(wire=True), quantity-0 probes in one window)
    exactly as the single-device limiter on the card and as the same
    mesh on CPU shards: results, insight totals, per-tenant counters,
    the mesh top-K, each shard's real-slot state; `shards` window
    launches per window and none of the row kernels.  Then a snapshot
    of the mesh restores through `shards` x ceil(n_d / 65,536) row
    launches, each key on its shard with its state."""
    from throttlecrab_tpu_torch.parallel import (
        ShardedTorchRateLimiter,
        make_mesh,
    )
    from throttlecrab_tpu_torch.parallel.tenants import TenantRegistry

    def mesh_on(devices, capacity=2048):
        return ShardedTorchRateLimiter(
            capacity, mesh=make_mesh(devices=devices), keymap="native",
            insight=True, tenants=TenantRegistry(max_tenants=9))

    card = mesh_on([cuda_device] * shards)
    cpu = mesh_on(["cpu"] * shards)
    single = TorchRateLimiter(capacity=1 << 14, keymap="native",
                              insight=True)
    rng = np.random.default_rng(shards)
    t0 = 1_753_700_000 * NS
    for w in range(6):
        batches = []
        for j in range(4):
            ids = rng.integers(0, 4000, 1024)
            q = np.where((w == 3) & (ids % 7 == 0), 0, 1)
            keys = [b"t%d:k%d" % (i % 8, i) for i in ids.tolist()]
            batches.append((keys, 2 + ids % 5, 5 + ids % 50,
                            10 + ids % 30, q, t0 + w * NS // 4))
        outs = []
        for lim in (card, cpu, single):
            before = (fused.LAUNCHES, row_ops.GATHER_LAUNCHES,
                      row_ops.SCATTER_LAUNCHES)
            outs.append(lim.dispatch_many(batches, wire=True).fetch())
            torch.cuda.synchronize()
            if lim is card:
                assert (fused.LAUNCHES - before[0], row_ops.GATHER_LAUNCHES,
                        row_ops.SCATTER_LAUNCHES) == (shards, *before[1:])
        for res in outs[1:]:
            for a, b in zip(outs[0], res):
                for f in ("allowed", "remaining", "reset_after_s",
                          "retry_after_s", "status"):
                    assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert card.table.insight_counts() == cpu.table.insight_counts() == (
        single.table.insight_counts())
    assert card.tenant_stats() == cpu.tenant_stats()
    for d in range(shards):
        assert sorted(card.keymaps[d].items()) == sorted(
            cpu.keymaps[d].items())
        cap = card.table.capacity  # grown on one shard: 4,000 keys
        assert torch.equal(card.table.shards[d].state[:cap].cpu(),
                           cpu.table.shards[d].state[:cap])
    for got, want in zip(card.table.insight_topk(16),
                         cpu.table.insight_topk(16)):
        assert torch.equal(got, want)
    want_chunks = [-(-len(km) // row_ops.MAX_BATCH) for km in card.keymaps]
    payload = snapshot.export_snapshot_payload(card)
    again = mesh_on([cuda_device] * shards, card.table.capacity)
    before = row_ops.SCATTER_LAUNCHES
    snapshot._bulk_insert(again, payload["keys"], payload["tat"],
                          payload["expiry"])
    torch.cuda.synchronize()
    assert row_ops.SCATTER_LAUNCHES - before == sum(want_chunks)
    for d in range(shards):
        assert sorted(k for k, _ in again.keymaps[d].items()) == sorted(
            k for k, _ in card.keymaps[d].items())
    got = snapshot.export_state(again)
    assert dict(zip(got[0], zip(got[3].tolist(), got[4].tolist()))) == dict(
        zip(payload["keys"], zip(payload["tat"].tolist(),
                                 payload["expiry"].tolist())))


def _small_cluster_phase(monkeypatch):
    """chip_smoke.py's phase 16a at a small size: 3 nodes of 2^14 slots,
    20,000 config-3 keys, batches of 512."""
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    for name, value in (("CLUSTER_CAPACITY", 1 << 14), ("N_KEYS", 20_000),
                        ("B", 512), ("CLUSTER_STEADY", 12),
                        ("CLUSTER_STEP", 6)):
        monkeypatch.setattr(chip_smoke, name, value)
    return chip_smoke


def test_cluster_phase_on_cpu_equals_single_device(monkeypatch):
    """The phase's own checks on the CPU (the plain versions, so no
    launch is counted): three nodes decide every batch as one limiter
    does, through a kill with a replica takeover, a fresh rejoin and a
    planned leave, with no client failure, and each owner decides one
    sub-batch per batch while all are up."""
    rec = _small_cluster_phase(monkeypatch).run_cluster_in_process(
        "cpu", device="cpu")
    assert rec["steady"]["decided"] == rec["steady"]["expected"] == 36
    assert rec["kill"]["takeovers"] >= 1
    assert rec["kill"]["expected_row_scatter"] >= 1
    assert rec["rejoin"]["migrated_in"] > 0 and rec["leave"]["leaves"] == 1
    assert rec["rejoin"]["expected_row_gather"] >= 2


@pytest.mark.cuda
def test_cluster_on_card_equals_single_device(cuda_device, monkeypatch):
    """The same on the card: every window launch is an owner-decided
    sub-batch, and the row kernels launch ceil(rows / 65,536) times per
    export and per insert of the takeover, the rejoin and the leave."""
    rec = _small_cluster_phase(monkeypatch).run_cluster_in_process(
        "card", device="cuda")
    for step in ("steady", "kill", "rejoin", "leave"):
        assert rec[step]["window_launches"] == rec[step]["decided"] > 0
    for step in ("kill", "rejoin", "leave"):
        for name in ("row_gather", "row_scatter"):
            assert rec[step][name] == rec[step][f"expected_{name}"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3100, 3101])  # edges / hostile (6-wide)
def test_tier_ladder_alternation_on_card(cuda_device, seed):
    """The campaign's alternation on the card: each window decided by the
    kernel and by a device="cpu" twin (the plain version), both held to the
    scalar oracle, their states equal after every window and handed
    across on alternate steps, with the mesh as two slices of the card;
    the window launches equal the windows decided on the card."""
    before = dict(fz.TOTAL)
    fz.run_seed(seed, steps=6, sharded_mesh=fz.campaign_mesh("cuda"),
                alternate=True, insight_single=bool(seed % 2))
    windows = fz.TOTAL["card_windows"] - before["card_windows"]
    assert windows > 0
    assert fz.TOTAL["launches"] - before["launches"] == windows


@pytest.mark.cuda
@pytest.mark.parametrize("K,B,cap", [(4, 64, 4096), (16, 4096, 1 << 21)])
def test_profile_launch_on_card_equals_cpu(cuda_device, tmp_path, K, B, cap):
    """tools/profile_launch.py on the card: step 3's first window (output
    and table state) equals the device="cpu" run of the same payload, and
    fused.LAUNCHES moves by exactly the windows the profile counted."""
    from throttlecrab_tpu_torch.tools import profile_launch as pl

    before = fused.LAUNCHES
    report, (out, state) = pl.profile(cuda_device, B=B, K=K, cap=cap,
                                      trace_dir=str(tmp_path),
                                      log=lambda line: None)
    torch.cuda.synchronize()
    assert fused.LAUNCHES - before == report["launches_counted"] > 0
    assert report["compute_kernels_per_call"] in (None, 1)
    want_out, want_state = pl.first_window("cpu", B=B, K=K, cap=cap)
    assert torch.equal(out, want_out)
    assert torch.equal(state, want_state)


@pytest.mark.cuda
def test_replay_gate_passes_on_card(cuda_device):
    """tools/replay_determinism.py on the card: the three contracts hold
    and the three replays launch one window per conflict round."""
    from throttlecrab_tpu_torch.tools import replay_determinism as rd

    rc, counts, line = rd.run(24, cuda_device)
    assert rc == 0, line
    assert counts["launches"] == counts["expected_launches"] == 3 * 24
