"""The masks' statistics (``ops/mask_stats.py``) on the CPU:

* the wrapper's plain path against exact int64 sums, on ragged K, a pixel
  count that is not a multiple of 16, empty and all-ones masks, with and
  without the extra column;
* the wrapper as it runs on a card (its device check made to say CUDA, the
  launch recorded): what it passes to K7, its counters, its refusals;
* K7's launch plan and a numpy rehearsal of the kernel's arithmetic
  (``k7_rehearsal``: the grid of tile pairs, chunks and images, the rows
  split by phase into TMA boxes with their coordinates and zero fill, the
  staged boxes of rows that start mid-chunk and their realignment, the
  two warpgroups' products in the wgmma accumulator layout, the i <= j
  atomics, the packing), which must give the exact statistics bit for
  bit.  Change it with the kernel.
"""

import numpy as np
import pytest
import torch

from pctrans_torch.ops import _build
from pctrans_torch.ops import mask_stats as ms
from pctrans_torch.utils import tracing

torch.set_num_threads(1)

HW = (13, 11)      # 143 pixels: not a multiple of 16, 8 or 4


def exact_packed(masks: np.ndarray, extra=None) -> np.ndarray:
    """[B, K, K+1(+1)] f32 from int64 sums."""
    B, K = masks.shape[:2]
    flat = masks.reshape(B, K, -1).astype(np.int64)
    cols = [np.einsum("bkp,bjp->bkj", flat, flat), flat.sum(-1)[:, :, None]]
    if extra is not None:
        cols.append(extra[:, :, None])
    return np.concatenate([c.astype(np.float32) for c in cols], -1)


def random_masks(rng, B, K, hw, fill="random"):
    if fill == "empty":
        return np.zeros((B, K, *hw), np.uint8)
    if fill == "ones":
        return np.ones((B, K, *hw), np.uint8)
    density = rng.rand(1, K, 1, 1)
    return (rng.rand(B, K, *hw) < density).astype(np.uint8)


@pytest.mark.parametrize("with_extra", [False, True])
@pytest.mark.parametrize("fill", ["random", "empty", "ones"])
@pytest.mark.parametrize("K", [1, 7, 50, 100, 161])
def test_plain_path_is_exact(K, fill, with_extra):
    rng = np.random.RandomState(K)
    masks = random_masks(rng, 2, K, HW, fill)
    extra = rng.randn(2, K).astype(np.float32) if with_extra else None
    got = ms.packed_mask_stats(torch.from_numpy(masks),
                               None if extra is None else torch.from_numpy(extra))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, K, K + 1 + with_extra)
    np.testing.assert_array_equal(got.numpy(), exact_packed(masks, extra))
    twin = ms.packed_mask_stats(torch.from_numpy(masks),
                                None if extra is None else torch.from_numpy(extra),
                                impl="twin")
    assert torch.equal(got, twin)
    areas, inter = ms.mask_stats_twin(torch.from_numpy(masks))
    assert areas.dtype == inter.dtype == torch.int32
    np.testing.assert_array_equal(inter.numpy(), got[..., :K].numpy())
    np.testing.assert_array_equal(areas.numpy(), got[..., K].numpy())


class FakeLibrary:
    """The kernel library's K7 entry point, recording its launches."""

    def __init__(self):
        self.launches = []

    def pctrans_mask_stats(self, *args):
        self.launches.append(args)
        return 0


@pytest.fixture
def on_a_card(monkeypatch):
    lib = FakeLibrary()
    monkeypatch.setattr(_build, "use_kernel", lambda t, impl, op: impl is None)
    monkeypatch.setattr(_build, "load_kernels", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(ms, "_sm_count", lambda dev: 132)
    return lib


def test_k7_launch_arguments_and_counters(on_a_card):
    masks = torch.zeros(4, 50, 530, 500, dtype=torch.uint8)
    peaks = torch.randn(4, 50, dtype=torch.float64)
    before = ms.packed_mask_stats.launches
    tracing.reset()
    tracing.enable()
    try:
        with tracing.span("eval.dispatch", key=0):
            out = ms.packed_mask_stats(masks, peaks)
            ms.packed_mask_stats(masks)
    finally:
        tracing.disable()
    assert tuple(out.shape) == (4, 50, 52) and out.dtype == torch.float32
    assert ms.packed_mask_stats.launches == before + 2
    assert [(name, n) for name, _, _, n in tracing.table()["counts"]] == [
        ("mask_stats_kernel", 2)]
    (m, extra, ws, o, B, K, P, tiles, chunks, spc, stream), second = on_a_card.launches
    assert (m, o, B, K, P, tiles, stream) == (masks.data_ptr(), out.data_ptr(), 4, 50,
                                              265_000, 1, 0)
    assert extra is not None and second[1] is None
    assert (chunks, spc) == ms.plan(4, 50, 265_000, 132)[1:]
    assert chunks * spc * ms.STAGE_PX >= P > (chunks - 1) * spc * ms.STAGE_PX
    tracing.reset()


@pytest.mark.parametrize("case", ["bool", "f32", "3-D", "strided", "extra"])
def test_k7_refuses_what_it_cannot_take(on_a_card, case):
    masks = torch.zeros(2, 7, 16, 16, dtype=torch.uint8)
    extra = None
    if case == "bool":
        masks = masks.bool()
    elif case == "f32":
        masks = masks.float()
    elif case == "3-D":
        masks = masks[0]
    elif case == "strided":
        masks = masks.transpose(2, 3)
    else:
        extra = torch.zeros(2, 6)
    with pytest.raises(ValueError, match="packed_mask_stats"):
        ms.packed_mask_stats(masks, extra)
    assert on_a_card.launches == []


def test_wrapper_refuses_other_impls():
    with pytest.raises(ValueError, match="impl"):
        ms.packed_mask_stats(torch.zeros(1, 2, 4, 4, dtype=torch.uint8), impl="kernel")


# ------------------------------------------------------------ the plan
@pytest.mark.parametrize("B,K,hw", [(4, 50, (530, 500)), (4, 100, (530, 500)),
                                    (2, 160, (520, 696)), (2, 300, (520, 696))])
def test_plan_fills_the_card_at_the_path_shapes(B, K, hw):
    P = hw[0] * hw[1]
    p = ms.plan(B, K, P, 132)
    pairs = p.tiles * (p.tiles + 1) // 2
    assert p.tiles == -(-K // ms.TILE)
    blocks = pairs * p.chunks * B
    assert abs(blocks - ms.BLOCKS_PER_SM * 132) <= B * pairs     # one wave
    assert p.chunks * p.stages_per_chunk * ms.STAGE_PX >= P
    assert (p.chunks - 1) * p.stages_per_chunk * ms.STAGE_PX < P


# ------------------------------------------------------------ rehearsal
def phases(P):
    """Rows split by q mod n, n the least power of two with n P a multiple
    of 16: each phase's rows lie n P bytes apart (TMA's row stride)."""
    n = 1
    while (n * P) % 16:
        n *= 2
    return n


@pytest.mark.parametrize("P,n", [(361_920, 1), (265_000, 2), (266_060, 4), (6, 8), (4_221, 16)])
def test_phases_make_row_strides_a_multiple_of_16(P, n):
    assert phases(P) == n and (n * P) % 16 == 0
    assert n == 1 or (n // 2 * P) % 16


def box_rows(n, ph):
    return (-(-n // ph) + 7) // 8 * 8


def k7_rehearsal(masks, extra, sms, address=0):
    """K7's arithmetic in numpy, block by block: the TMA boxes of each
    phase (their coordinates, zero fill past P and past the last row; a
    phase off a 16-byte boundary staged 16 bytes wider and realigned), the
    two warpgroups' products into the wgmma accumulator layout (a diagonal
    pair's second warpgroup on rows 64-127 only), each pair's one atomic
    and the packing, for masks [B, K, H, W] u8 at ``address``
    (mod 16) -> the packed f32 statistics."""
    B, K = masks.shape[:2]
    flat = masks.reshape(-1)
    P = flat.size // max(1, B * K)
    tile, stage_px = ms.TILE, ms.STAGE_PX
    p = ms.plan(B, K, P, sms)
    n_ph = phases(P)
    rows = [(B * K - ph + n_ph - 1) // n_ph if B * K > ph else 0 for ph in range(n_ph)]
    off = [(address + ph * P) % 16 for ph in range(n_ph)]
    # the phase tensors as TMA sees them: base backed off by off[ph], rows
    # n_ph P bytes apart, P + off[ph] bytes each, zero outside
    padded = np.concatenate([np.zeros(16, np.uint8), flat, np.zeros(n_ph * P + 16, np.uint8)])

    def tensor_box(ph, x, y, box, width):
        out = np.zeros((box, width), np.uint8)
        for t in range(box):
            if y + t >= rows[ph]:
                break
            lo, hi = max(x, 0), min(x + width, P + off[ph])
            start = 16 + (ph + n_ph * (y + t)) * P - off[ph]
            if hi > lo:
                out[t, lo - x:hi - x] = padded[start + lo:start + hi]
        return out

    def phase_box(ph, x, y, box):
        """A direct box (off 0), or a staged box 16 bytes wider realigned
        by off."""
        if off[ph] == 0:
            return tensor_box(ph, x, y, box, stage_px)
        return tensor_box(ph, x, y, box, stage_px + 16)[:, off[ph]:off[ph] + stage_px]

    def row0(q_start, ph):
        return (q_start - ph + n_ph - 1) // n_ph

    def row_mask(s, box, q_start, qb, lo, hi):
        ph = s // box
        if ph >= n_ph:
            return -1
        m = ph + n_ph * (row0(q_start, ph) + s - ph * box) - qb
        return m if lo <= m < hi else -1

    def warpgroup_columns(wg, diag, box_j):
        """(N, the first column's row in J's region): in a diagonal pair the
        second warpgroup takes rows 64-127 only."""
        if diag and wg == 1:
            return 64, 64
        return (128 if n_ph * box_j > 64 else 64), 0

    ws = np.zeros((B, K, K), np.int64)
    pairs = [(i, j) for i in range(p.tiles) for j in range(i, p.tiles)]   # blockIdx.x order
    lane = np.arange(32)
    for b in range(B):
        qb = b * K
        for chunk in range(p.chunks):
            px_begin = chunk * p.stages_per_chunk * stage_px
            px_end = min(P, px_begin + p.stages_per_chunk * stage_px)
            n_stages = -(-(px_end - px_begin) // stage_px)
            for I, J in pairs:
                diag = I == J
                box_i = box_rows(K - I * tile if I == p.tiles - 1 else tile, n_ph)
                box_j = box_rows(K - J * tile if J == p.tiles - 1 else tile, n_ph)
                qi, qj = qb + I * tile, qb + J * tile
                d = np.zeros((2, 64, 128), np.int64)       # per warpgroup: 64 rows, N cols
                for s in range(n_stages):
                    px0 = px_begin + s * stage_px
                    reg_i = np.zeros((tile, stage_px), np.uint8)    # stale rows read 0 here
                    reg_j = np.zeros((tile, stage_px), np.uint8)
                    for ph in range(n_ph):
                        if rows[ph] == 0:
                            continue
                        reg_i[ph * box_i:(ph + 1) * box_i] = phase_box(
                            ph, px0, row0(qi, ph), box_i)
                        reg_j[ph * box_j:(ph + 1) * box_j] = phase_box(
                            ph, px0, row0(qj, ph), box_j)
                    bm = reg_i if diag else reg_j
                    for wg in range(2):
                        if wg * 64 < n_ph * box_i:
                            n, col0 = warpgroup_columns(wg, diag, box_j)
                            a = reg_i[wg * 64:wg * 64 + 64].astype(np.int64)
                            d[wg, :, :n] += a @ bm[col0:col0 + n].astype(np.int64).T
                assert np.abs(d).max(initial=0) < 2 ** 31               # s32 partials
                for wg in range(2):
                    if not wg * 64 < n_ph * box_i:
                        continue
                    n, col0 = warpgroup_columns(wg, diag, box_j)
                    for w in range(4):
                        # register 4c + 2h + e of each lane
                        for h in range(2):
                            for c in range(n // 8):
                                for e in range(2):
                                    for ln in lane:
                                        r = 16 * w + ln // 4 + 8 * h
                                        col = col0 + 8 * c + 2 * (ln % 4) + e
                                        i = row_mask(wg * 64 + r, box_i, qi, qb, I * tile,
                                                     min(K, I * tile + tile))
                                        j = row_mask(col, box_j, qj, qb, J * tile,
                                                     min(K, J * tile + tile))
                                        v = d[wg, r, col - col0]
                                        both = diag and (col < 64) == (wg == 0)
                                        if i >= 0 and j >= 0 and v != 0 and (not both or i <= j):
                                            ws[b, min(i, j), max(i, j)] += v
    assert ws.max(initial=0) < 2 ** 31                                # i32 workspace
    cols = K + 1 + (extra is not None)
    out = np.zeros((B, K, cols), np.float32)
    i, j = np.meshgrid(np.arange(K), np.arange(K), indexing="ij")
    out[:, :, :K] = ws[:, np.minimum(i, j), np.maximum(i, j)]
    out[:, :, K] = ws[:, np.arange(K), np.arange(K)]
    if extra is not None:
        out[:, :, K + 1] = extra
    return out


@pytest.mark.parametrize("B,K,hw,sms,address", [
    (1, 1, (5, 7), 1, 0),             # one mask, one partial stage, 16 phases
    (2, 50, (20, 24), 3, 0),          # CVPPP's top-K count, several chunks, one phase
    (2, 100, (17, 24), 2, 8),         # CVPPP's full Q: one tile, two phases, an offset base
    (1, 150, (9, 28), 1, 4),          # two tiles (three pairs), a ragged one, four phases
])
def test_k7_rehearsal_gives_the_exact_statistics(B, K, hw, sms, address):
    rng = np.random.RandomState(K)
    masks = random_masks(rng, B, K, hw)
    masks[:, 0] = 1                                # an all-ones mask
    if K > 2:
        masks[:, 1] = 0                            # an empty one
    extra = rng.randn(B, K).astype(np.float32)
    got = k7_rehearsal(masks, extra, sms, address)
    np.testing.assert_array_equal(got, exact_packed(masks, extra))
    np.testing.assert_array_equal(got[..., :-1], k7_rehearsal(masks, None, sms, address))
