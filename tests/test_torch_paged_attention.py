"""K4 and K5's plain versions against the JAX reference, on the CPU.

The port's ``ops.paged_decode_gqa`` / ``ops.prefix_prefill`` on CPU
tensors (their plain versions: gather or concatenate, then one masked
softmax) against ``repro.kernels.ops.*(backend="xla")``, the reference's
gather+attend path, at the shapes of ``tests/test_paged_attention.py``:
the garbage page, ragged positions including 0 and the last slot
position, ``ctx_len`` 0 and L, L = 0, bfloat16 pages and bfloat16
context pages cast to the compute dtype.  Held to ATOL = RTOL = 1e-6:
scores, softmax and PV are float32 on both sides, in different
summation orders (XLA's einsums against torch's), so they agree to a
few float32 ulps of the output's magnitude (~1).  The kernels are held
to these plain versions on the card (``test_torch_kernels_gpu.py``).

K5's tensor-core walk (``csrc/prefix_prefill.cu``, bf16 q, K and V) is
emulated in torch: 64-row tiles of flattened (position, head) rows r =
t*G + g, 16 rows a warp, key tiles of 64 (or 32) over the context, then
the tail up to the tile's last position, a warp skipping tail tiles
past its own last position and masking only where a tile needs it, the
online softmax with the unnormalised weights rounded to bf16.  It is
held to the plain version and to the JAX reference on the same bf16
inputs at ATTN_TOL = 2e-2: the two round the weights to bf16 at
different points (unnormalised against normalised), one bf16 ulp (2^-8)
apart per weight at most.

K4's tensor-core split walk (``csrc/paged_decode_gqa.cu``, bf16 q and
pages) is emulated the same way: the pages a split from the wrapper's
own rule, splits wholly past pos skipped, 64-key tiles of which each of
4 warps takes 16 keys with its own online softmax, the warps and then
the live splits merged by their maxima and sums.  Held to the plain
version and to JAX at ATTN_TOL, for the same reason.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import cuda_lib, ops, paged_attention

TOL = dict(rtol=1e-6, atol=1e-6)
ATTN_TOL = dict(rtol=2e-2, atol=2e-2)
# One compiled program per shape is quicker here than op-by-op dispatch.
_jdecode = jax.jit(functools.partial(jops.paged_decode_gqa, backend="xla"))
_jprefill = jax.jit(functools.partial(jops.prefix_prefill, backend="xla"))


def _bf16(a):
    """numpy float32 -> (jax bf16 array, torch bf16 tensor) of the same bits."""
    j = jnp.asarray(a, jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)
    return j, t


def _block_table(rng, B, nb, n_pages):
    """Distinct non-garbage pages per (slot, idx); page 0 is reserved."""
    return rng.permutation(np.arange(1, n_pages))[: B * nb].reshape(B, nb).astype(np.int32)


def _decode_both(q, kp, vp, bt, pos):
    jk, tk = _bf16(kp)
    jv, tv = _bf16(vp)
    want = _jdecode(jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(pos))
    before = dict(cuda_lib.launches)
    got = ops.paged_decode_gqa(torch.from_numpy(q), tk, tv, torch.from_numpy(bt),
                               torch.from_numpy(pos))
    assert cuda_lib.launches == before          # a CPU tensor never launches
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("B,Hk,G,hd,hdv,page,nb", [
    (1, 1, 1, 8, 8, 4, 1),
    (3, 2, 4, 16, 16, 8, 3),
    (2, 2, 1, 16, 8, 8, 2),
    (4, 1, 6, 32, 32, 16, 2),
])
def test_paged_decode_gqa(B, Hk, G, hd, hdv, page, nb):
    rng = np.random.default_rng(B * 100 + nb)
    n_pages = 1 + B * nb + 3
    kp = rng.standard_normal((n_pages, page, Hk, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, Hk, hdv)).astype(np.float32)
    bt = _block_table(rng, B, nb, n_pages)
    q = rng.standard_normal((B, 1, Hk * G, hd)).astype(np.float32)
    pos = rng.integers(0, nb * page, B).astype(np.int32)
    pos[0] = 0
    pos[-1] = nb * page - 1
    _decode_both(q, kp, vp, bt, pos)


def test_paged_decode_garbage_page_rows():
    """An inactive slot names page 0 throughout at position 0: only key 0
    of the garbage page is attended, and the output is finite."""
    rng = np.random.default_rng(7)
    B, Hk, G, hd, page, nb = 3, 2, 2, 16, 8, 2
    n_pages = 1 + B * nb
    kp = rng.standard_normal((n_pages, page, Hk, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, Hk, hd)).astype(np.float32)
    bt = _block_table(rng, B, nb, n_pages)
    bt[1] = 0
    q = rng.standard_normal((B, 1, Hk * G, hd)).astype(np.float32)
    _decode_both(q, kp, vp, bt, np.asarray([5, 0, nb * page - 1], np.int32))


def _prefill_both(q, kc, vc, kt, vt, ctx):
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    want = _jprefill(j(q), j(kc), j(vc), j(kt), j(vt), j(ctx))
    got = ops.prefix_prefill(t(q), t(kc), t(vc), t(kt), t(vt), t(ctx))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("B,T,Hk,G,hd,L", [
    (1, 1, 1, 1, 8, 0),
    (3, 7, 2, 4, 16, 16),
    (2, 8, 2, 1, 16, 24),
    (2, 5, 1, 3, 8, 8),
    (2, 12, 2, 2, 8, 0),
])
def test_prefix_prefill(B, T, Hk, G, hd, L):
    rng = np.random.default_rng(B + T + L)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, kt, vt = f32(B, T, Hk * G, hd), f32(B, T, Hk, hd), f32(B, T, Hk, hd)
    if L:
        kc, vc = f32(B, L, Hk, hd), f32(B, L, Hk, hd)
        ctx = rng.integers(0, L + 1, B).astype(np.int32)
        ctx[0] = 0                                  # a burst member without a hit
        ctx[-1] = L                                 # a fully valid context
    else:
        kc = vc = None
        ctx = np.zeros(B, np.int32)
    _prefill_both(q, kc, vc, kt, vt, ctx)


def test_prefix_prefill_bf16_context_pages():
    """Serving casts the gathered bfloat16 context pages to the compute
    dtype before attending."""
    rng = np.random.default_rng(3)
    B, T, Hk, G, hd, L = 2, 4, 2, 2, 16, 16
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q = f32(B, T, Hk * G, hd)
    kc = np.array(jnp.asarray(f32(B, L, Hk, hd), jnp.bfloat16).astype(jnp.float32))
    vc = np.array(jnp.asarray(f32(B, L, Hk, hd), jnp.bfloat16).astype(jnp.float32))
    _prefill_both(q, kc, vc, f32(B, T, Hk, hd), f32(B, T, Hk, hd), np.asarray([7, L], np.int32))


def test_prefix_prefill_padded_tail_rows_are_finite():
    """Right-padded (all-zero) tail rows, as burst prefill gives the
    padding rows of a batch, still see their own tail column."""
    rng = np.random.default_rng(9)
    B, T, Hk, G, hd, L = 2, 6, 1, 2, 8, 8
    q = np.zeros((B, T, Hk * G, hd), np.float32)
    kt = np.zeros((B, T, Hk, hd), np.float32)
    q[0, :3] = rng.standard_normal((3, Hk * G, hd))
    kt[0, :3] = rng.standard_normal((3, Hk, hd))
    vt = rng.standard_normal((B, T, Hk, hd)).astype(np.float32)
    kc = rng.standard_normal((B, L, Hk, hd)).astype(np.float32)
    _prefill_both(q, kc, kc.copy(), kt, vt, np.asarray([L, 0], np.int32))


# --- K5's tensor-core walk, emulated -----------------------------------------------
ROWS, WARP_ROWS = 64, 16          # flattened rows a CTA, and a warp


def _tile_walk(q, kc, vc, kt, vt, ctx_len, keys):
    """The tensor-core kernel's algorithm on bf16 tensors, in float32
    with the kernel's roundings: q * scale to bf16, the unnormalised
    weights to bf16 before PV, the row sums from the unrounded weights.
    Returns (B, T, H, hdv) float32."""
    B, T, H, hd = q.shape
    Hk, hdv = kt.shape[2], vt.shape[-1]
    G = H // Hk
    L = 0 if kc is None else kc.shape[1]
    qs = (q.float() * (1.0 / math.sqrt(hd))).to(torch.bfloat16).float()
    out = torch.full((B, T, H, hdv), float("nan"))
    for b in range(B):
        n_ctx = min(max(int(ctx_len[b]), 0), L)
        for h in range(Hk):
            rows = qs[b, :, h * G:(h + 1) * G].reshape(T * G, hd)      # r = t*G + g
            for r0 in range(0, T * G, ROWS):
                t_hi = min(T - 1, (r0 + ROWS - 1) // G)
                tiles = ([(True, c0) for c0 in range(0, n_ctx, keys)]
                         + [(False, c0) for c0 in range(0, t_hi + 1, keys)])
                for w0 in range(r0, r0 + ROWS, WARP_ROWS):
                    r = torch.arange(w0, w0 + WARP_ROWS)
                    t = r // G
                    qw = torch.zeros(WARP_ROWS, hd)
                    real = r < T * G
                    qw[real] = rows[r[real]]
                    m = torch.full((WARP_ROWS,), float("-inf"))
                    lsum = torch.zeros(WARP_ROWS)
                    o = torch.zeros(WARP_ROWS, hdv)
                    for ctx, c0 in tiles:
                        if not ctx and c0 > (w0 + WARP_ROWS - 1) // G:
                            continue                    # the whole tile is past the warp
                        n_cols = n_ctx if ctx else t_hi + 1
                        n = min(keys, n_cols - c0)
                        ks, vs = (kc, vc) if ctx else (kt, vt)
                        kk, vv = torch.zeros(keys, hd), torch.zeros(keys, hdv)
                        kk[:n] = ks[b, c0:c0 + n, h].float()
                        vv[:n] = vs[b, c0:c0 + n, h].float()
                        s = qw @ kk.T
                        if c0 + keys > n_cols or (not ctx and c0 + keys - 1 > w0 // G):
                            col = torch.arange(c0, c0 + keys)[None, :]
                            live = col < n_cols
                            if not ctx:
                                live = live & (col <= t[:, None])
                            s = s.masked_fill(~live, float("-inf"))
                        m_new = torch.maximum(m, s.max(dim=1).values)
                        alpha = torch.exp(m - m_new)
                        m = m_new
                        p = torch.exp(s - m[:, None])
                        lsum = lsum * alpha + p.sum(dim=1)
                        o = o * alpha[:, None] + p.to(torch.bfloat16).float() @ vv
                    for i in torch.nonzero(real).flatten().tolist():
                        ti, gi = divmod(int(r[i]), G)
                        out[b, ti, h * G + gi] = o[i] / lsum[i]
    return out


@pytest.mark.parametrize("keys", [64, 32])
@pytest.mark.parametrize("B,T,Hk,G,hd,hdv,L", [
    (2, 9, 1, 80, 16, 8, 16),        # G = 80: 720 rows, a ragged last tile
    (3, 37, 2, 4, 16, 24, 80),       # ctx_len 0, partial, L; a partial context tile
    (2, 70, 1, 1, 8, 16, 0),         # G = 1, tail tiles past a warp skipped
    (1, 1, 1, 1, 8, 8, 0),           # T = 1
    (3, 40, 2, 3, 8, 8, 130),        # three heads a position, warps across positions
])
def test_prefix_prefill_tile_walk(B, T, Hk, G, hd, hdv, L, keys):
    rng = np.random.default_rng(B * 31 + T + G + L + keys)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q = f32(B, T, Hk * G, hd)
    q[:, T // 2 + 1:] = 0.0                         # rows of zero queries
    (jq, tq), (jkt, tkt), (jvt, tvt) = _bf16(q), _bf16(f32(B, T, Hk, hd)), _bf16(f32(B, T, Hk, hdv))
    if L:
        (jkc, tkc), (jvc, tvc) = _bf16(f32(B, L, Hk, hd)), _bf16(f32(B, L, Hk, hdv))
        ctx = rng.integers(1, L + 1, B).astype(np.int32)
        ctx[0], ctx[-1] = 0, L
    else:
        jkc = tkc = jvc = tvc = None
        ctx = np.zeros(B, np.int32)
    got = _tile_walk(tq, tkc, tvc, tkt, tvt, torch.from_numpy(ctx), keys)
    assert torch.isfinite(got).all()
    plain = ops.prefix_prefill(tq, tkc, tvc, tkt, tvt, torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **ATTN_TOL)
    want = _jprefill(jq, jkc, jvc, jkt, jvt, jnp.asarray(ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **ATTN_TOL)


# --- K4's tensor-core split walk, emulated -------------------------------------------
WARPS, WARP_KEYS = 4, 16          # warps a CTA, and keys a warp takes of each tile


def _split_walk(q, kp, vp, bt, pos, sms):
    """The split kernel and its merge on bf16 tensors, in float32 with the
    kernel's roundings: pages a split from ``paged_attention.decode_split``,
    splits wholly past pos[b] skipped, 64-key tiles of which each of 4
    warps takes 16 keys with its own online softmax (the unnormalised
    weights rounded to bf16 before PV), the warps merged by their maxima
    and sums into one partial a split, then the live splits merged the
    same way.  Returns (B, 1, H, hdv) float32."""
    B, _, H, hd = q.shape
    n_pages, page, Hk, _ = kp.shape
    hdv, nb = vp.shape[-1], bt.shape[1]
    G = H // Hk
    pps = paged_attention.decode_split(B, Hk, G, page, nb, sms)
    kps, splits = pps * page, -(-nb // pps)
    qs = (q.float() * (1.0 / math.sqrt(hd))).to(torch.bfloat16).float()
    out = torch.full((B, 1, H, hdv), float("nan"))

    def merge(parts):                                  # [(m, l, o)] -> (m, l, o)
        m = torch.stack([p[0] for p in parts]).max(dim=0).values
        f = [torch.exp(p[0] - m) for p in parts]
        return (m, sum(p[1] * fi for p, fi in zip(parts, f)),
                sum(p[2] * fi[:, None] for p, fi in zip(parts, f)))

    for b in range(B):
        last = min(max(int(pos[b]), 0), nb * page - 1)
        keys = torch.arange(nb * page)
        rows = bt[b, keys // page].long().clamp(0, n_pages - 1) * page + keys % page
        kf = kp.reshape(n_pages * page, Hk, hd)[rows].float()
        vf = vp.reshape(n_pages * page, Hk, hdv)[rows].float()
        for h in range(Hk):
            qh = qs[b, 0, h * G:(h + 1) * G]
            parts = []
            for s in range(splits):
                k_lo = s * kps
                if k_lo > last:
                    continue                           # the CTA returns at once
                k_end = min(k_lo + kps, last + 1)
                warps = [(torch.full((G,), float("-inf")), torch.zeros(G), torch.zeros(G, hdv))
                         for _ in range(WARPS)]
                for t0 in range(k_lo, k_end, 64):
                    n = min(64, k_end - t0)
                    for w in range(WARPS):
                        c0 = w * WARP_KEYS
                        if c0 >= n:
                            continue                   # the warp's keys are past the tile
                        j = torch.arange(c0, c0 + WARP_KEYS)
                        live = j < n
                        kk, vv = torch.zeros(WARP_KEYS, hd), torch.zeros(WARP_KEYS, hdv)
                        kk[live] = kf[t0 + j[live], h]
                        vv[live] = vf[t0 + j[live], h]
                        sc = (qh @ kk.T).masked_fill(~live[None], float("-inf"))
                        m, lsum, o = warps[w]
                        m_new = torch.maximum(m, sc.max(dim=1).values)
                        alpha = torch.exp(m - m_new)
                        p = torch.exp(sc - m_new[:, None])
                        warps[w] = (m_new, lsum * alpha + p.sum(dim=1),
                                    o * alpha[:, None] + p.to(torch.bfloat16).float() @ vv)
                parts.append(merge(warps))
            assert len(parts) == last // kps + 1      # the merge kernel's live count
            _, lsum, o = merge(parts)
            out[b, 0, h * G:(h + 1) * G] = o / lsum[:, None]
    return out


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("B,Hk,G,hd,hdv,page,nb", [
    (4, 1, 1, 16, 16, 16, 12),       # G = 1; 64-key splits, 3 a slot
    (4, 2, 20, 16, 8, 16, 12),       # G > 16: two row tiles; hdv != hd
    (4, 2, 8, 8, 24, 3, 50),         # 66-key splits: a 2-key last tile; hdv != hd
    (2, 1, 3, 7, 5, 1, 200),         # one key a page, a short last split
])
def test_paged_decode_split_walk(B, Hk, G, hd, hdv, page, nb, sms):
    rng = np.random.default_rng(B * 37 + G + hd + page + sms)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    n_pages = 1 + B * nb + 2
    (jq, tq), (jk, tk), (jv, tv) = (_bf16(f32(B, 1, Hk * G, hd)), _bf16(f32(n_pages, page, Hk, hd)),
                                    _bf16(f32(n_pages, page, Hk, hdv)))
    bt = _block_table(rng, B, nb, n_pages)
    bt[-1] = 0                                      # an inactive slot: all garbage page
    kps = paged_attention.decode_split(B, Hk, G, page, nb, sms) * page
    # A full slot, a split's last key and the key one past it (the later
    # splits wholly past pos), and the inactive slot at 0.
    pos = np.asarray([nb * page - 1, kps - 1, kps][:B - 1] + [0], np.int32)
    pos = np.minimum(pos, nb * page - 1)
    got = _split_walk(tq, tk, tv, torch.from_numpy(bt), torch.from_numpy(pos), sms)
    assert torch.isfinite(got).all()
    plain = ops.paged_decode_gqa(tq, tk, tv, torch.from_numpy(bt), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **ATTN_TOL)
    want = _jdecode(jq, jk, jv, jnp.asarray(bt), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **ATTN_TOL)
