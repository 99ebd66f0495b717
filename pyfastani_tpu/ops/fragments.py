"""Batched device winnowing and sketch construction for query fragments.

The reference maps each 3 kb fragment on a thread pool
(``_fastani.pyx:1099-1102``); here the fragment axis is a vectorized batch
dimension: one jitted program winnows every fragment of a genome, sorts
per-fragment hashes, and compacts them to unique sketch hashes -- all
integer outputs, so the host-side and device-side engines agree bitwise.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.jaxconfig import configure as _configure_jax
from . import layout2d
from . import winnow as wops
from . import winnow2d as w2d

_configure_jax()

__all__ = ["winnow_fragments", "winnow_long_sequence"]

_UMAX = np.uint32(0xFFFFFFFF)  # numpy, not jnp: see note in ops/l2.py


@functools.partial(
    jax.jit, static_argnames=("k", "w", "length", "protein", "kc")
)
def _winnow_fragments_impl(
    frags, k: int, w: int, length: int, protein: bool, kc: int = 1024
):
    """frags: (F, length + pad) uint8 -> (rec_ovf bool, hash (F,P) u32,
    q_sorted (F, min(kc, P)) u32 sketch hashes sorted ascending with UMAX
    padding, s (F,) int32 sketch sizes).

    ``kc`` bounds the returned sketch width; ``rec_ovf`` flags fragments
    whose unique-hash count exceeded it (caller escalates).  (A
    scatter-compaction before the sort is an alternative that has not
    been timed on the GPU.)"""
    n_pos = length - k + 1

    def one(frag):
        if protein:
            canon, valid = wops.prot_hashes(jnp, frag, length, k, n_pos)
        else:
            canon, valid = wops.nucl_canonical(jnp, frag, length, k, n_pos)
        return wops.winnow(jnp, canon, valid, w)

    record, win_hash = jax.vmap(one)(frags)

    # per-fragment sketch: sorted unique hashes of recorded minimizers
    masked = jnp.where(record, win_hash, _UMAX)
    s_sorted = jnp.sort(masked, axis=1)
    # first-occurrence mask (UMAX padding collapses into the tail)
    first = jnp.ones_like(record)
    first = first.at[:, 1:].set(s_sorted[:, 1:] != s_sorted[:, :-1])
    first = first & (s_sorted != _UMAX)
    q_sorted = jnp.sort(jnp.where(first, s_sorted, _UMAX), axis=1)
    s = jnp.sum(first, axis=1).astype(jnp.int32)
    rec_ovf = jnp.any(s > kc)
    return rec_ovf, win_hash, q_sorted[:, : min(kc, q_sorted.shape[1])], s


@functools.partial(jax.jit, static_argnames=("k", "w", "length", "protein"))
def _winnow_fragments_sketch(frags, k: int, w: int, length: int, protein: bool):
    # only the sketch outputs -- the per-window record/hash arrays stay on
    # device (copying an (F, P) per-window array to the host is waste)
    rec_ovf, _, q_sorted, s = _winnow_fragments_impl.__wrapped__(
        frags, k, w, length, protein
    )
    # kc=1024 covers any real fragment (max records ~2*(l-k)/(w+1) + slack);
    # make truncation loud rather than silent if it ever happens
    q_sorted = jnp.where(rec_ovf, jnp.uint32(0xFFFFFFFF), q_sorted)
    s = jnp.where(rec_ovf, -1, s)
    return q_sorted, s


def winnow_fragments(frags_np: np.ndarray, k: int, w: int, protein: bool):
    """Host wrapper: frags_np (F, length) uint8 -> (q_sorted, s) numpy.

    Returns each fragment's sorted unique sketch hashes (UMAX padded) and
    sketch size; the raw per-window minimizer stream never leaves device.
    """
    F, length = frags_np.shape
    padded = np.zeros((F, length + 4), dtype=np.uint8)
    padded[:, :length] = frags_np
    q_sorted, s = _winnow_fragments_sketch(jnp.asarray(padded), k, w, length, protein)
    return np.asarray(q_sorted), np.asarray(s)


_CHUNK_WINDOWS = 1 << 21  # windows winnowed per device call


@functools.partial(
    jax.jit, static_argnames=("k", "w", "B", "protein", "first_chunk", "cap")
)
def _winnow_chunk2d_jit(
    slice2d,  # (R, 128) u8: bytes data[base : base + R*128]
    q_hi,  # int32: valid k-mer positions in this slice
    base,  # int32: global position of flat index 0
    take,  # int32: only windows [0, take) of this chunk are emitted
    carry,  # (has_prev, prev_pos(global), phantom, h0)
    k: int,
    w: int,
    B: int,
    protein: bool,
    first_chunk: bool,
    cap: int,
):
    """Winnow one chunk and compact its minimizer records on device.

    The dense per-window record/hash arrays never leave the device
    (they are ~25x the size of the records): records are counted with a
    flattened prefix sum and scattered into (cap,)-sized output buffers.
    Returns (hashes (capR,128) u32, wpos (capR,128) i32, count, carry);
    ``count > cap`` means the caller must retry with a larger cap.
    """
    record, win_hash, carry = w2d.winnow_chunk2d(
        jnp,
        slice2d,
        q_hi,
        base,
        carry,
        k=k,
        w=w,
        B=B,
        protein=protein,
        first_chunk=first_chunk,
    )
    R, C = record.shape
    iota = jnp.arange(R * C, dtype=jnp.int32).reshape(R, C)
    emit = record & (iota < take)
    (cnt,) = layout2d.prefix_scan(
        jnp, lambda a, b: (a[0] + b[0],), (emit.astype(jnp.int32),), (0,)
    )
    count = cnt[-1, -1]
    cap_r = cap // 128
    tgt = jnp.where(emit, cnt - 1, cap_r * 128)  # out-of-range = dump row
    rows_t = jnp.minimum(tgt // 128, cap_r)
    cols_t = tgt % 128
    out_h = jnp.zeros((cap_r + 1, 128), jnp.uint32)
    out_p = jnp.zeros((cap_r + 1, 128), jnp.int32)
    out_h = out_h.at[rows_t, cols_t].set(win_hash)
    out_p = out_p.at[rows_t, cols_t].set(iota + base)
    return out_h[:cap_r], out_p[:cap_r], count, carry


def winnow_long_sequence(
    data_np: np.ndarray, k: int, w: int, protein: bool, chunk: int | None = None
):
    """Winnow one long sequence on device, in fixed-size (R, 128) chunks.

    One compiled shape serves every sequence length (the reference
    streams through a fixed 2*2048-byte ring buffer for the same reason,
    ``_fastani.pyx:179-196``).  Returns (hashes u32, wpos i32), identical
    to the host `winnow_sequence`.
    """
    n = int(data_np.shape[0])
    n_pos = n - k + 1
    n_windows = n_pos - w + 1
    if n_pos < 1 or n_windows < 1:
        return np.zeros(0, np.uint32), np.zeros(0, np.int32)

    B = chunk or _CHUNK_WINDOWS
    R = w2d.chunk_slice_rows(B, w, k)
    L = R * 128

    # minimizer density is ~2/(w+1); cap sized 2x that, with overflow retry
    cap = max(1024, (-(-4 * B // (w + 1)) // 128) * 128)

    carry = (
        jnp.asarray(False),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(False),
        jnp.asarray(0, jnp.uint32),
    )
    out_h, out_p = [], []
    for base in range(0, n_windows, B):
        sl = np.zeros(L, dtype=np.uint8)
        avail = data_np[base : base + L]
        sl[: avail.shape[0]] = avail
        slice_dev = jnp.asarray(sl.reshape(R, 128))
        take = min(B, n_windows - base)
        chunk_cap = cap
        while True:
            oh, op, count, new_carry = _winnow_chunk2d_jit(
                slice_dev,
                np.int32(n_pos - base),
                np.int32(base),
                np.int32(take),
                carry,
                k,
                w,
                B,
                protein,
                base == 0,
                chunk_cap,
            )
            n = int(count)
            if n <= chunk_cap:
                break
            # overflow (pathologically dense minimizers): retry bigger
            chunk_cap = (-(-n // 128)) * 128
        carry = new_carry
        out_h.append(np.asarray(oh).ravel()[:n])
        out_p.append(np.asarray(op).ravel()[:n])
    return (
        np.concatenate(out_h) if out_h else np.zeros(0, np.uint32),
        np.concatenate(out_p) if out_p else np.zeros(0, np.int32),
    )
