"""Composite multi-level operator: the stencil-form irregular-lattice SpMV.

Why this exists: the padded-ELL gather SpMV is the natural *generic* sparse
format, but it reads an index and a value per nonzero, while contiguous
row/box gathers and static slices read only the vector.  The
multi-resolution lattice has exactly the structure needed to avoid element
gathers almost everywhere:

* points sorted level-major (all boxes of one spacing contiguous) make each
  level a dense (nbox, m, m, m) array — the reference's box decomposition
  (IrrGrid.py:341-374) turned into an array layout;
* an interior point's aligned stencil touches only same-level points
  (different-spacing contact implies the mirror-filtered "edge path",
  IrrGrid.py:97-137), so each level's kinetic term is ONE 27-point stencil
  over its boxes with halos exchanged along the box-adjacency graph
  (IrrGrid.py:364-374) — pure slicing plus box-index take;
* only the interface rows (the 7-14% edge fraction the writeup quantifies,
  notes.tex:332) need their exact LSQ rows applied, via a small masked ELL
  gather.

The operator is numerically identical to the EllOperator assembled from the
same lattice (tests cross-check), but runs as per-level stencils instead of
element gathers.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .operators import LinearOperator

__all__ = [
    "CompositeOperator",
    "build_composite",
    "ShardedComposite",
    "ShardedCompositeOperator",
    "shard_composite",
]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LevelBlock:
    """One spacing level: a dense stack of same-size box subgrids.

    adjacency[b, d] = index (within this level) of the box in direction d of
    box b, or -1 when that neighbor has a different spacing (its halo face is
    zero-filled; rows that would read it are interface rows and get
    overwritten).  Directions enumerate the 26 nonzero offsets of {-1,0,1}^3
    in itertools.product order.
    """

    adjacency: jax.Array  # (nbox, 26) int32
    weights: jax.Array  # (27,) aligned-stencil weights (incl. center 0)
    start: int = dataclasses.field(metadata=dict(static=True))
    nbox: int = dataclasses.field(metadata=dict(static=True))
    m: int = dataclasses.field(metadata=dict(static=True))


_DIRS = tuple(v for v in itertools.product((-1, 0, 1), repeat=3) if any(v))

#: Interface block width: aligned block size for the block-ELL gather.  32
#: keeps each (z, y) line of a neighbor cloud inside 1-2 blocks (fewer
#: fetched blocks) at acceptable padded-lane waste.
IFC_W = 32


def _halo_pad(xl: jax.Array, adj: jax.Array) -> jax.Array:
    """(nbox, m, m, m) -> (nbox, m+2, m+2, m+2) with 26-direction halos.

    Each direction's halo is a face/edge/corner slab taken from the adjacent
    box (a take over the box axis — contiguous block gather),
    zeroed where adjacency is -1.  Coordinate axes are (z, y, x) slow->fast;
    direction tuples are (dx, dy, dz) per the lattice's axis-0-fastest
    convention, so component 0 indexes the LAST array axis.
    """
    nbox, m = xl.shape[0], xl.shape[1]
    out = jnp.zeros((nbox, m + 2, m + 2, m + 2), xl.dtype)
    out = out.at[:, 1:-1, 1:-1, 1:-1].set(xl)

    def src_dst(d_axis):
        # Neighbor in +1 dir along an axis: my halo plane at index m+1 comes
        # from ITS plane 0; -1 dir: halo plane 0 from its plane m-1.
        if d_axis == 1:
            return slice(0, 1), slice(m + 1, m + 2)
        if d_axis == -1:
            return slice(m - 1, m), slice(0, 1)
        return slice(0, m), slice(1, m + 1)

    for d, disp in enumerate(_DIRS):
        nbr = adj[:, d]
        # take with clipped index; mask invalid boxes to zero.
        src_box = jnp.take(xl, jnp.maximum(nbr, 0), axis=0)
        valid = (nbr >= 0).astype(xl.dtype)[:, None, None, None]
        dx, dy, dz = disp
        sz, tz = src_dst(dz)
        sy, ty = src_dst(dy)
        sx, tx = src_dst(dx)
        out = out.at[:, tz, ty, tx].set(src_box[:, sz, sy, sx] * valid)
    return out


def _stencil27(hal: jax.Array, weights: jax.Array) -> jax.Array:
    """Apply the (dz, dy, dx) in {-1,0,1}^3 stencil to haloed boxes.

    weights are ordered by itertools.product over (dx, dy, dz) with the
    center INCLUDED (27 entries), matching the offset order used when the
    level weights are built.
    """
    m = hal.shape[1] - 2
    y = None
    k = 0
    for dx, dy, dz in itertools.product((-1, 0, 1), repeat=3):
        sl = hal[:, 1 + dz : 1 + dz + m, 1 + dy : 1 + dy + m, 1 + dx : 1 + dx + m]
        term = weights[k] * sl
        y = term if y is None else y + term
        k += 1
    return y


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CompositeOperator(LinearOperator):
    """H = diag + per-level aligned stencils + exact interface rows.

    Vector ordering is the lattice's level-major point order (see
    build_composite); eigenvectors come out in that order.
    """

    diag: jax.Array  # (P,)
    levels: Tuple[LevelBlock, ...]
    ifc_rows: jax.Array  # (R,) int32 interface row ids
    ifc_cols: jax.Array  # (R, K) int32 column ids (padded with row id)
    ifc_vals: jax.Array  # (R, K) values incl. the diagonal entry, 0 on pad
    # Block-ELL form of the same interface rows: columns grouped into
    # IFC_W-wide aligned blocks with the values pre-scattered into per-lane
    # weight vectors.  The SpMV then needs only sum_b R_b*B_b whole-block row
    # gathers + einsums — no element
    # gathers.  Rows are BUCKETED by their real block count (the count
    # distribution is heavily skewed: median ~11 vs max ~47 on the N=96
    # deuteron lattice) so padding blocks are not fetched for the majority.
    # Each bucket is (rows (Rb,), blk_ids (Rb, Bb), blk_w (Rb, Bb, IFC_W)).
    ifc_buckets: Tuple[Tuple[jax.Array, jax.Array, jax.Array], ...]

    @property
    def shape(self):
        p = self.diag.shape[0]
        return (p, p)

    @property
    def dtype(self):
        return self.diag.dtype

    def _interior(self, x):
        """(D + sum_l S_l) x — the diagonal plus every level's stencil.

        S_l is block-diagonal by level (cross-level halo faces are zero by
        construction), and symmetric: the aligned LSQ weights are mirror-
        symmetric and the same-level box adjacency is a symmetric relation.
        """
        y = self.diag * x
        for lv in self.levels:
            n = lv.nbox * lv.m**3
            xl = jax.lax.slice_in_dim(x, lv.start, lv.start + n).reshape(
                lv.nbox, lv.m, lv.m, lv.m
            )
            t = _stencil27(_halo_pad(xl, lv.adjacency), lv.weights)
            y = y.at[lv.start : lv.start + n].add(t.reshape(-1))
        return y

    def _x_blocks(self, x):
        m = self.diag.shape[0]
        pad = (-m) % IFC_W
        xp = jnp.pad(x, (0, pad)) if pad else x
        return xp.reshape(-1, IFC_W)

    def matvec(self, x):
        # H x = M_int (D + sum S) x + M_ifc ELL x: compute the composite
        # stencil everywhere, then overwrite the interface rows with their
        # full exact LSQ rows (incl. diagonal).  The interface rows apply in
        # bucketed block-ELL form: whole-block row gathers contracted against
        # precomputed per-lane weights.
        y = self._interior(x)
        xb = self._x_blocks(x)
        for rows, blk_ids, blk_w in self.ifc_buckets:
            g = xb[blk_ids]  # (Rb, Bb, W) block gather
            contrib = jnp.einsum("rbw,rbw->r", blk_w, g)
            y = y.at[rows].set(contrib)
        return y

    def rmatvec(self, x):
        # H^T x = (D + sum S) M_int x + ELL^T M_ifc x (D, S symmetric).
        # The ELL^T term is the block scatter-add dual of the matvec gather.
        u = x.at[self.ifc_rows].set(0.0)
        y = self._interior(u)
        m = self.diag.shape[0]
        yb = jnp.zeros_like(self._x_blocks(y))
        for rows, blk_ids, blk_w in self.ifc_buckets:
            xr = x[rows]
            yb = yb.at[blk_ids].add(blk_w * xr[:, None, None])
        return y + yb.reshape(-1)[:m]

    def matmat(self, X):
        return jax.vmap(self.matvec, in_axes=1, out_axes=1)(X)


def build_composite(
    lat,
    nbrs: np.ndarray,
    rels: np.ndarray,
    weights: np.ndarray,
    diag: np.ndarray,
    scale: float,
    dtype=np.float32,
    interior_weights=None,
) -> Tuple[CompositeOperator, np.ndarray]:
    """Build the composite operator from assembled LSQ rows.

    Inputs are in the LATTICE's point order (as produced by
    irregular_laplacian_rows): off-diagonal values are ``scale * weights``
    and the diagonal vector is passed ready-made.  Returns (operator, perm)
    where perm maps lattice order -> operator (level-major) order:
    operator_vector = lattice_vector[perm].

    ``interior_weights``: optional ``a -> (26,)`` callable giving the shared
    aligned-stencil weights (offset product order, center excluded, offsets
    scaled by the level spacing ``a``) that every interior row at spacing
    ``a`` is assumed to carry.  Default: the LSQ Laplacian weights — correct
    for rows produced by irregular_laplacian_rows; other row sources (e.g.
    the graph Laplacian of scripts/northstar.py: constant -1) must supply
    theirs, since interior rows are applied through this shared stencil, not
    through the per-row ``weights`` array (which still feeds the interface
    rows).

    Requires a 3D lattice.  Interface rows are those whose neighbor cloud is
    not the aligned own-spacing 26-stencil (equivalently lattice
    ``differs`` + widened rows).
    """
    from ..models.lattice import _local_max_spacing

    if lat.ndim != 3:
        raise ValueError("composite operator requires a 3D lattice")
    p = lat.num_points
    bd = lat.box_depth
    nb = bd**3
    npb = lat.n_per_box
    spac = np.asarray(lat.spacings, dtype=np.int64)

    # ---- level-major permutation of points (boxes sorted by spacing).
    box_order = np.argsort(spac, kind="stable")
    counts = (npb // spac) ** 3
    starts = np.concatenate([[0], np.cumsum(counts)])  # lattice box offsets
    perm = np.concatenate(
        [np.arange(starts[b], starts[b + 1]) for b in box_order]
    )
    inv = np.empty(p, dtype=np.int64)
    inv[perm] = np.arange(p)

    # ---- which rows are interface rows: not the aligned 26-stencil.
    _, _, differs = _local_max_spacing(lat, np.arange(p), 1)
    deg = (nbrs >= 0).sum(axis=1)
    interface = differs | (deg != 26)

    # ---- per-level blocks, in permuted space.
    levels = []
    new_start = 0
    bcoord = np.stack(
        [(np.arange(nb) // bd**k) % bd for k in range(3)], axis=1
    )  # (nb, 3) component 0 fastest
    dirs = np.asarray(_DIRS, dtype=np.int64)
    for a in np.unique(spac):
        boxes = box_order[spac[box_order] == a]
        nbox = len(boxes)
        m = int(npb // a)
        rank = {int(b): i for i, b in enumerate(boxes)}
        adj = np.full((nbox, 26), -1, dtype=np.int32)
        for i, b in enumerate(boxes):
            for d, disp in enumerate(dirs):
                nc = (bcoord[b] + disp) % bd
                nbid = int(nc @ (bd ** np.arange(3)))
                if spac[nbid] == a:
                    adj[i, d] = rank[nbid]
        # Aligned stencil weights at this spacing: offsets (dx,dy,dz)*a,
        # product order INCLUDING the center (weight 0 placeholder -> the
        # diagonal is handled by `diag`).
        from ..models.irrlap import laplacian_weights

        offs = np.array(
            list(itertools.product((-1, 0, 1), repeat=3)), dtype=np.int64
        )  # (27, 3) as (dx, dy, dz)
        nz = np.any(offs != 0, axis=1)
        if interior_weights is not None:
            w26 = np.asarray(interior_weights(int(a)), dtype=np.float64)
        else:
            w26 = laplacian_weights((offs[nz] * a).astype(np.float64))
        w27 = np.zeros(27)
        w27[nz] = scale * w26
        levels.append(
            LevelBlock(
                adjacency=jnp.asarray(adj),
                weights=jnp.asarray(w27, dtype=dtype),
                start=int(new_start),
                nbox=nbox,
                m=m,
            )
        )
        new_start += nbox * m**3
    assert new_start == p

    # ---- interface rows in permuted space, padded ELL with diagonal merged.
    rows_l = np.nonzero(interface)[0]
    if len(rows_l):
        k_if = int(deg[rows_l].max()) + 1  # +1 for the diagonal column
        r = len(rows_l)
        cols = np.tile(inv[rows_l][:, None], (1, k_if))
        vals = np.zeros((r, k_if), dtype=np.float64)
        emask = np.zeros((r, k_if), dtype=bool)
        emask[:, 0] = True
        vals[:, 0] = diag[rows_l]
        sub_n = nbrs[rows_l]
        sub_w = weights[rows_l]
        mask = sub_n >= 0
        rr, cc = np.nonzero(mask)
        pos = np.concatenate([[0], np.cumsum(mask.sum(axis=1))])
        within = np.arange(len(rr)) - pos[rr]
        cols[rr, 1 + within] = inv[sub_n[rr, cc]]
        vals[rr, 1 + within] = scale * sub_w[rr, cc]
        emask[rr, 1 + within] = True
        ifc_rows = inv[rows_l]
        buckets = _block_ell_buckets(ifc_rows, cols, vals, emask, dtype)
    else:
        k_if = 1
        ifc_rows = np.zeros(0, dtype=np.int64)
        cols = np.zeros((0, 1), dtype=np.int64)
        vals = np.zeros((0, 1), dtype=np.float64)
        buckets = ()

    op = CompositeOperator(
        diag=jnp.asarray(diag[perm], dtype=dtype),
        levels=tuple(levels),
        ifc_rows=jnp.asarray(ifc_rows, dtype=jnp.int32),
        ifc_cols=jnp.asarray(cols, dtype=jnp.int32),
        ifc_vals=jnp.asarray(vals, dtype=dtype),
        ifc_buckets=buckets,
    )
    return op, perm


def _block_ell(cols: np.ndarray, vals: np.ndarray, emask: np.ndarray):
    """Group each ELL row's (col, val) entries into IFC_W-aligned blocks.

    Returns (blk_ids (R, B), blk_w (R, B, IFC_W)): per row, the sorted
    unique aligned block indices its columns fall into, with values
    scattered onto their lane positions.  sum_k val_k x[col_k] then equals
    sum_b dot(blk_w[b], x_blocks[blk_ids[b]]), i.e. the SpMV needs only
    whole-block gathers.  Padding blocks have id 0 and zero weights.
    """
    r, k = cols.shape
    bid = cols // IFC_W
    lane = cols % IFC_W
    big = bid.max() + 1 if r else 1
    keyed = np.where(emask, bid, big)  # push padding entries to the end
    order = np.argsort(keyed, axis=1, kind="stable")
    b_s = np.take_along_axis(keyed, order, 1)
    l_s = np.take_along_axis(lane, order, 1)
    v_s = np.take_along_axis(vals, order, 1)
    m_s = np.take_along_axis(emask, order, 1)

    new = m_s.copy()
    new[:, 1:] &= b_s[:, 1:] != b_s[:, :-1]
    bpos = np.cumsum(new, axis=1) - 1  # block slot per entry
    nblk = new.sum(axis=1)
    b = max(int(nblk.max()), 1)

    blk_ids = np.zeros((r, b), dtype=np.int64)
    blk_w = np.zeros((r, b, IFC_W), dtype=np.float64)
    rr, cc = np.nonzero(m_s)
    blk_ids[rr, bpos[rr, cc]] = b_s[rr, cc]
    np.add.at(blk_w, (rr, bpos[rr, cc], l_s[rr, cc]), v_s[rr, cc])
    return blk_ids, blk_w, nblk


def _block_ell_buckets(ifc_rows, cols, vals, emask, dtype, max_buckets=4):
    """Bucket interface rows by real block count to avoid fetching padding.

    Chooses bucket boundaries over the (few) distinct block counts to
    minimize total fetched blocks sum_b R_b * B_b, then emits per-bucket
    (rows, blk_ids, blk_w) trimmed to the bucket's max count.
    """
    blk_ids, blk_w, nblk = _block_ell(cols, vals, emask)
    order = np.argsort(nblk, kind="stable")
    sorted_n = nblk[order]
    r = len(order)

    # Greedy split: walk the sorted counts; start a new bucket when padding
    # the current bucket to the next count would cost more than a new fetch
    # batch.  With <= ~50 distinct counts a simple boundary scan suffices:
    # pick boundaries at counts where the padded-cost jump is largest.
    uniq = np.unique(sorted_n)
    bounds = [int(uniq[-1])]
    work = [(0, r)]
    # Recursively split the worst segment until max_buckets.
    segs = [(0, r)]
    for _ in range(max_buckets - 1):
        best = None
        for si, (lo, hi) in enumerate(segs):
            seg = sorted_n[lo:hi]
            if len(seg) == 0 or seg[0] == seg[-1]:
                continue
            cost0 = len(seg) * seg[-1]
            # best single split inside this segment
            for cut in np.unique(seg)[:-1]:
                idx = int(np.searchsorted(seg, cut, side="right"))
                cost = idx * cut + (len(seg) - idx) * seg[-1]
                gain = cost0 - cost
                if best is None or gain > best[0]:
                    best = (gain, si, lo + idx)
        if best is None or best[0] <= 0:
            break
        _, si, mid = best
        lo, hi = segs[si]
        segs[si : si + 1] = [(lo, mid), (mid, hi)]

    buckets = []
    for lo, hi in segs:
        if hi == lo:
            continue
        sel = order[lo:hi]
        bmax = max(int(nblk[sel].max()), 1)
        buckets.append(
            (
                jnp.asarray(ifc_rows[sel], dtype=jnp.int32),
                jnp.asarray(blk_ids[sel, :bmax], dtype=jnp.int32),
                jnp.asarray(blk_w[sel, :bmax], dtype=dtype),
            )
        )
    return tuple(buckets)


# ---------------------------------------------------------------------------
# Sharded composite: row-partitioned multi-level operator for shard_map.
#
# Partition rule: each level's box stack is split CONTIGUOUSLY across the D
# mesh devices (padded with ghost boxes so every device holds c_l =
# ceil(nbox_l / D) boxes per level); the global vector layout is
# device-major — device d owns one contiguous (P_loc,) slice holding its
# boxes of every level.  Cross-device halo exchange rides ONE all_gather of
# a per-box FACE TABLE per level: each box publishes its 6 face planes
# (6 m^2 elements, the 7-14% boundary fraction of notes.tex:332 in array
# form); every face/edge/corner halo slab any neighbor needs is a static
# slice of one published face.  Interface rows are applied from their
# owning device via the same bucketed block-ELL gathers against an
# all-gathered x (their support is sparse but global).

_FACE_SPECS = (
    # (axis of xl sliced, index) for faces 0..5: x-min, x-max, y-min, y-max,
    # z-min, z-max.  xl axes are (box, z, y, x).
    (3, 0),
    (3, -1),
    (2, 0),
    (2, -1),
    (1, 0),
    (1, -1),
)


def _face_pack(xl: jax.Array) -> jax.Array:
    """(nbox, m, m, m) -> (nbox, 6, m, m): the 6 face planes of every box."""
    faces = []
    for ax, idx in _FACE_SPECS:
        faces.append(jax.lax.index_in_dim(xl, idx % xl.shape[ax], axis=ax,
                                          keepdims=False))
    return jnp.stack(faces, axis=1)


def _halo_pad_from_faces(
    xl: jax.Array, adj: jax.Array, faces_g: jax.Array
) -> jax.Array:
    """(c, m, m, m) -> (c, m+2, m+2, m+2) with halos from a global face table.

    ``adj[b, d]``: LEVEL-GLOBAL rank of box b's neighbor in direction d (-1
    when the neighbor has a different spacing).  ``faces_g``:
    (nbox_pad, 6, m, m) all-gathered face table in global rank order.
    """
    c, m = xl.shape[0], xl.shape[1]
    out = jnp.zeros((c, m + 2, m + 2, m + 2), xl.dtype)
    out = out.at[:, 1:-1, 1:-1, 1:-1].set(xl)

    def tgt(dcomp):
        if dcomp == 1:
            return slice(m + 1, m + 2)
        if dcomp == -1:
            return slice(0, 1)
        return slice(1, m + 1)

    def src(dcomp):
        # neighbor plane nearest to me: +1 dir -> its min plane (index 0)
        if dcomp == 1:
            return slice(0, 1)
        if dcomp == -1:
            return slice(m - 1, m)
        return slice(0, m)

    for d, (dx, dy, dz) in enumerate(_DIRS):
        nbr = adj[:, d]
        valid = (nbr >= 0).astype(xl.dtype)[:, None, None, None]
        safe = jnp.maximum(nbr, 0)
        if dx != 0:
            fidx = 0 if dx == 1 else 1
            face = jnp.take(faces_g[:, fidx], safe, axis=0)  # (c, z, y)
            slab = face[:, src(dz), :][:, :, src(dy)][:, :, :, None]
        elif dy != 0:
            fidx = 2 if dy == 1 else 3
            face = jnp.take(faces_g[:, fidx], safe, axis=0)  # (c, z, x)
            slab = face[:, src(dz), :][:, :, None, :]
        else:
            fidx = 4 if dz == 1 else 5
            face = jnp.take(faces_g[:, fidx], safe, axis=0)  # (c, y, x)
            slab = face[:, None, :, :]
        out = out.at[:, tgt(dz), tgt(dy), tgt(dx)].set(slab * valid)
    return out


@dataclasses.dataclass(frozen=True)
class ShardedComposite:
    """Host-side container of the device-major sharded composite.

    All device-leading arrays are FLAT over devices (first dim D*<local>) so
    shard_map's PartitionSpec can split them; ``local_matvec`` is the SPMD
    body closure.  ``P_loc`` is the per-device vector length; the global
    sharded vector is (D * P_loc,).  ``to_sharded``/``from_sharded`` map
    level-major composite vectors into/out of the sharded layout.
    """

    num_devices: int
    P_loc: int
    # static per-level: (c_local_boxes, m, start_local_offset)
    level_meta: Tuple[Tuple[int, int, int], ...]
    level_adj: Tuple[jax.Array, ...]  # each (D*c_l, 26) int32, level-global
    level_weights: Tuple[jax.Array, ...]  # each (27,) replicated
    diag: jax.Array  # (D*P_loc,)
    keep: jax.Array  # (D*P_loc,) 1 except interface rows & ghost slots
    ifc_rows: jax.Array  # (D*R,) LOCAL row ids (0 for padding)
    ifc_blk_ids: jax.Array  # (D*R, B) into the padded global block table
    ifc_blk_w: jax.Array  # (D*R, B, IFC_W)
    idx_map: np.ndarray  # level-major index -> sharded global index

    @property
    def shape(self):
        p = self.diag.shape[0]
        return (p, p)

    @property
    def dtype(self):
        return self.diag.dtype

    def to_sharded(self, x_levelmajor: np.ndarray) -> np.ndarray:
        out = np.zeros(self.num_devices * self.P_loc, x_levelmajor.dtype)
        out[self.idx_map] = x_levelmajor
        return out

    def from_sharded(self, x_sharded: np.ndarray) -> np.ndarray:
        return np.asarray(x_sharded)[self.idx_map]

    def live_mask(self) -> np.ndarray:
        """1.0 on live slots, 0.0 on ghost padding (mask start vectors with
        this: ghost components would otherwise ride along in the basis as
        spurious null-space directions)."""
        live = np.zeros(self.num_devices * self.P_loc, dtype=np.float64)
        live[self.idx_map] = 1.0
        return live

    def as_operator(self, mesh, axis_name: str = "rows") -> "ShardedCompositeOperator":
        op = ShardedCompositeOperator(
            diag=self.diag,
            keep=self.keep,
            ifc_rows=self.ifc_rows,
            ifc_blk_ids=self.ifc_blk_ids,
            ifc_blk_w=self.ifc_blk_w,
            level_adj=tuple(self.level_adj),
            level_weights=tuple(self.level_weights),
            level_meta=self.level_meta,
            mesh=mesh,
            axis_name=axis_name,
        )
        object.__setattr__(op, "host", self)  # host-side maps (not a pytree leaf)
        return op


def shard_composite(comp: CompositeOperator, num_devices: int) -> ShardedComposite:
    """Re-partition a CompositeOperator for a D-device row mesh.

    Boxes of each level are split contiguously over devices (ghost-padded to
    equal counts); the returned object's vector layout is device-major (see
    ShardedComposite).  Numerically identical to ``comp`` on live slots.
    """
    D = num_devices
    levels = comp.levels
    p = comp.diag.shape[0]

    cs = [int(np.ceil(lv.nbox / D)) for lv in levels]
    p_loc = int(sum(c * lv.m**3 for c, lv in zip(cs, levels)))
    start_loc = np.concatenate(
        [[0], np.cumsum([c * lv.m**3 for c, lv in zip(cs, levels)])]
    ).astype(np.int64)

    # level-major -> sharded index map
    idx_map = np.empty(p, dtype=np.int64)
    for lv, c, sl in zip(levels, cs, start_loc[:-1]):
        n = lv.nbox * lv.m**3
        i = np.arange(n, dtype=np.int64)
        b = i // lv.m**3
        o = i % lv.m**3
        d = b // c
        r = b % c
        idx_map[lv.start + i] = d * p_loc + sl + r * lv.m**3 + o

    dtype = np.asarray(comp.diag).dtype
    diag_s = np.zeros(D * p_loc, dtype=dtype)
    diag_s[idx_map] = np.asarray(comp.diag)
    keep_s = np.zeros(D * p_loc, dtype=dtype)
    keep_s[idx_map] = 1.0
    ifc_rows_lm = np.asarray(comp.ifc_rows, dtype=np.int64)
    if len(ifc_rows_lm):
        keep_s[idx_map[ifc_rows_lm]] = 0.0

    # per-level adjacency, ghost-padded to (D*c, 26); ids stay level-global
    level_adj = []
    for lv, c in zip(levels, cs):
        adj = np.full((D * c, 26), -1, dtype=np.int32)
        adj[: lv.nbox] = np.asarray(lv.adjacency)
        level_adj.append(jnp.asarray(adj))

    # interface rows: map ids, group by owning device, single padded bucket
    if len(ifc_rows_lm):
        rows_s = idx_map[ifc_rows_lm]
        cols_s = idx_map[np.asarray(comp.ifc_cols, dtype=np.int64)]
        vals = np.asarray(comp.ifc_vals, dtype=np.float64)
        emask = np.zeros_like(vals, dtype=bool)
        emask[:, 0] = True  # diagonal column always real
        emask[:, 1:] = vals[:, 1:] != 0
        blk_ids_all, blk_w_all, nblk = _block_ell(cols_s, vals, emask)
        owner = rows_s // p_loc
        local_row = rows_s % p_loc
        rmax = max(int(np.bincount(owner, minlength=D).max()), 1)
        bmax = blk_ids_all.shape[1]
        rows_out = np.zeros((D, rmax), dtype=np.int32)
        blk_out = np.zeros((D, rmax, bmax), dtype=np.int64)
        w_out = np.zeros((D, rmax, bmax, IFC_W), dtype=np.float64)
        for d in range(D):
            sel = np.nonzero(owner == d)[0]
            rows_out[d, : len(sel)] = local_row[sel]
            blk_out[d, : len(sel)] = blk_ids_all[sel]
            w_out[d, : len(sel)] = blk_w_all[sel]
        ifc_rows = jnp.asarray(rows_out.reshape(-1))
        ifc_blk_ids = jnp.asarray(blk_out.reshape(D * rmax, bmax), dtype=jnp.int32)
        ifc_blk_w = jnp.asarray(w_out.reshape(D * rmax, bmax, IFC_W), dtype=dtype)
    else:
        ifc_rows = jnp.zeros(D, dtype=jnp.int32)
        ifc_blk_ids = jnp.zeros((D, 1), dtype=jnp.int32)
        ifc_blk_w = jnp.zeros((D, 1, IFC_W), dtype=dtype)

    return ShardedComposite(
        num_devices=D,
        P_loc=p_loc,
        level_meta=tuple(
            (c, lv.m, int(sl)) for c, lv, sl in zip(cs, levels, start_loc[:-1])
        ),
        level_adj=tuple(level_adj),
        level_weights=tuple(lv.weights for lv in levels),
        diag=jnp.asarray(diag_s),
        keep=jnp.asarray(keep_s),
        ifc_rows=ifc_rows,
        ifc_blk_ids=ifc_blk_ids,
        ifc_blk_w=ifc_blk_w,
        idx_map=idx_map,
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedCompositeOperator(LinearOperator):
    """LinearOperator facade over a ShardedComposite: matvec on GLOBAL
    (D*P_loc,) device-major vectors, SPMD body via shard_map.

    Composes with jit (shard_map nests inside it), so the standard solvers
    (solver.arnoldi.eigs_nonsym, solver.lanczos) run unchanged: their dense
    basis algebra partitions automatically under GSPMD once V/x carry the
    row sharding, while the matvec's halo structure runs through the
    explicit collectives here (all-gathered face tables + psum-free local
    stencils).
    """

    diag: jax.Array
    keep: jax.Array
    ifc_rows: jax.Array
    ifc_blk_ids: jax.Array
    ifc_blk_w: jax.Array
    level_adj: Tuple[jax.Array, ...]
    level_weights: Tuple[jax.Array, ...]
    level_meta: Tuple[Tuple[int, int, int], ...] = dataclasses.field(
        metadata=dict(static=True)
    )
    mesh: jax.sharding.Mesh = dataclasses.field(metadata=dict(static=True))
    axis_name: str = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self):
        p = self.diag.shape[0]
        return (p, p)

    @property
    def dtype(self):
        return self.diag.dtype

    def matvec(self, x):
        from jax.sharding import PartitionSpec as P

        row = P(self.axis_name)
        row2 = P(self.axis_name, None)
        row3 = P(self.axis_name, None, None)
        meta = self.level_meta
        axis_name = self.axis_name

        def body(diag_l, keep_l, rows, blk_ids, blk_w, adjs, weights, x_local):
            y = diag_l * x_local
            for (c, m, sl), adj, w in zip(meta, adjs, weights):
                n = c * m**3
                xl = jax.lax.slice_in_dim(x_local, sl, sl + n).reshape(
                    c, m, m, m
                )
                faces = _face_pack(xl)
                faces_g = jax.lax.all_gather(faces, axis_name, tiled=True)
                hal = _halo_pad_from_faces(xl, adj, faces_g)
                t = _stencil27(hal, w)
                y = y.at[sl : sl + n].add(t.reshape(-1))
            y = y * keep_l
            x_full = jax.lax.all_gather(x_local, axis_name, tiled=True)
            pad = (-x_full.shape[0]) % IFC_W
            if pad:
                x_full = jnp.pad(x_full, (0, pad))
            xb = x_full.reshape(-1, IFC_W)
            g = xb[blk_ids]
            contrib = jnp.einsum("rbw,rbw->r", blk_w, g)
            y = y.at[rows].add(contrib)
            return y

        mapped = jax.shard_map(
            body,
            mesh=self.mesh,
            in_specs=(
                row, row, row, row2, row3,
                tuple(row2 for _ in self.level_adj),
                tuple(P() for _ in self.level_weights),
                row,
            ),
            out_specs=row,
            check_vma=False,
        )
        return mapped(
            self.diag, self.keep, self.ifc_rows, self.ifc_blk_ids,
            self.ifc_blk_w, tuple(self.level_adj),
            tuple(self.level_weights), x,
        )

    def matmat(self, X):
        cols = [self.matvec(X[:, i]) for i in range(X.shape[1])]
        return jnp.stack(cols, axis=1)
