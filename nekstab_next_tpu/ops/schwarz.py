"""Exact element-block Schwarz preconditioner for the PnPn-2 pressure solve.

The two-level FDM+Q1 preconditioner (ops/fdm.py) approximates each element
by an axis-aligned box — adequate on mild meshes (~30 CG iterations on the
cylinder O-mesh) but it collapses on graded/stretched meshes (measured 1229
iterations to 1e-5 on the Barkley BFS fixture, round 3).  The reference
inherits Nek5000's overlapping-Schwarz + XXT hierarchy here (SURVEY.md
section 2.2, Fischer 1997 / Lottes & Fischer 2005); this module is the
JAX-native equivalent for the *discontinuous* P_{N-2} pressure space:

* The diagonal blocks  E_ee  of the pressure operator E = D M^-1 D^T are
  extracted EXACTLY — not approximated by a box — with a graph-colored set
  of batched operator applies: elements of one color are not E-coupled
  (no shared velocity node), so one apply of E to a same-color sum of unit
  basis fields yields one block column for every element of that color
  simultaneously.  Cost: ncolors x npr^d applies, host-side, once per mesh.
* The blocks are inverted on the host (npr^d <= 64 per element in 2-D) and
  applied as ONE batched (nelem, nloc, nloc) matmul — pure matmul work, less
  per-apply arithmetic than the FDM Gauss<->GLL lift it replaces.
* Two-level: additively combined with the existing Q1 vertex coarse solve
  (ops/fdm.py coarse_setup — the XXT equivalent), which carries the global
  low-frequency error the local blocks cannot see.

Because each block is a diagonal sub-block of the SPD operator E, the block
inverse is SPD, and the additive two-level sum stays SPD — a valid CG
preconditioner on any mesh, with no box-alignment assumption to break.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np


def make_pressure_operator(sem) -> Callable:
    """Standard-layout PnPn-2 pressure operator E = D M^-1 D^T (the operator
    navier_stokes.py solves each step; reference: Nek5000's E operator in
    the P_N/P_{N-2} splitting)."""
    u_example = jax.ShapeDtypeStruct(
        sem.bm.shape + (sem.ndim,), sem.dtype
    )
    div_w = sem.div_to_p
    grad_wt = jax.linear_transpose(div_w, u_example)
    vmask = sem.vmask
    binv = sem.binv_assembled[..., None]

    def Minv_free(g):
        return vmask * (binv * sem.dssum(vmask * g))

    def E_op(q):
        return div_w(Minv_free(grad_wt(q)[0]))

    return E_op


def element_adjacency(gid: np.ndarray):
    """Element coupling graph: e ~ e' iff they share a global velocity node
    (the stencil of E = D M^-1 D^T: M^-1 reaches exactly one layer of
    node-sharing neighbors).  Returns a list of sets (self included)."""
    E = gid.shape[0]
    flat = gid.reshape(E, -1)
    nodes = flat.reshape(-1)
    elem_of = np.repeat(np.arange(E), flat.shape[1])
    order = np.argsort(nodes, kind="stable")
    sn, se = nodes[order], elem_of[order]
    bnd = np.flatnonzero(np.diff(sn)) + 1
    starts = np.concatenate([[0], bnd])
    ends = np.concatenate([bnd, [sn.size]])
    adj = [{e} for e in range(E)]
    for s, e in zip(starts, ends):
        members = np.unique(se[s:e])
        if members.size > 1:
            for a in members:
                adj[a].update(members)
    return adj


def element_coupling_colors(gid: np.ndarray, distance: int = 1) -> np.ndarray:
    """Greedy coloring of the element coupling graph.

    ``distance=1``: same-colored elements are not E-coupled — enough to
    extract DIAGONAL blocks (the response is only read at the source).
    ``distance=2``: same-colored elements share no responder — required to
    extract OFF-diagonAL columns (the P0 coarse matrix)."""
    adj = element_adjacency(gid)
    E = len(adj)
    if distance == 2:
        adj = [set().union(*(adj[nb] for nb in a)) for a in adj]
    colors = -np.ones(E, dtype=np.int64)
    for e in range(E):
        used = {colors[nb] for nb in adj[e] if colors[nb] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[e] = c
    return colors


def extract_sparse_E(sem, E_op: Optional[Callable] = None) -> dict:
    """Extract ALL nonzero element-blocks of E = D M^-1 D^T exactly.

    E couples only node-sharing element pairs, so the response to a unit
    source is zero beyond distance 1 — with a distance-2 coloring (no two
    same-colored sources share a responder) one batched apply per
    (color, local-basis-index) reads off every block column attributable to
    a unique source.  Cost: ncolors x npr^d applies, once per mesh.

    Returns {(e_responder, e_source): (nloc, nloc) numpy block} with
    block[l, k] = E[(e_resp, l), (e_src, k)]."""
    if E_op is None:
        E_op = make_pressure_operator(sem)
    mesh = sem.mesh
    nelem = sem.nelem
    nloc = int(np.prod(sem.p_shape[1:]))
    p_shape = tuple(int(s) for s in sem.p_shape)
    gid = np.asarray(mesh.gid).reshape(nelem, -1)
    colors = element_coupling_colors(gid, distance=2)
    ncol = int(colors.max()) + 1

    apply_batch = jax.jit(jax.vmap(E_op))
    B: dict = {}
    for c in range(ncol):
        sel = colors == c
        basis = np.zeros((nloc, nelem, nloc))
        basis[np.arange(nloc)[:, None], sel, np.arange(nloc)[:, None]] = 1.0
        out = np.asarray(
            apply_batch(jnp.asarray(basis.reshape((nloc,) + p_shape),
                                    sem.dtype))
        ).reshape(nloc, nelem, nloc)
        src = _nearest_colored_source(mesh, colors, c)
        for e in np.flatnonzero(src >= 0):
            B[(int(e), int(src[e]))] = out[:, e].T.astype(np.float64)
    return B


def build_pressure_blocks(
    sem, E_op: Optional[Callable] = None
) -> jnp.ndarray:
    """Exact per-element diagonal blocks of E, inverted, as a device array
    (nelem, nloc, nloc) with nloc = npr^ndim.  Host-side, once per mesh."""
    if E_op is None:
        E_op = make_pressure_operator(sem)
    mesh = sem.mesh
    nelem = sem.nelem
    nloc = int(np.prod(sem.p_shape[1:]))
    p_shape = tuple(int(s) for s in sem.p_shape)
    colors = element_coupling_colors(np.asarray(mesh.gid).reshape(nelem, -1))
    ncol = int(colors.max()) + 1

    apply_batch = jax.jit(jax.vmap(E_op))
    blocks = np.zeros((nelem, nloc, nloc))
    for c in range(ncol):
        sel = colors == c
        basis = np.zeros((nloc, nelem, nloc))
        basis[np.arange(nloc)[:, None], sel, np.arange(nloc)[:, None]] = 1.0
        out = np.asarray(
            apply_batch(jnp.asarray(basis.reshape((nloc,) + p_shape),
                                    sem.dtype))
        ).reshape(nloc, nelem, nloc)
        # out[k, e, l] = E[e,l ; e,k] for e of this color
        blocks[sel] = out[:, sel].transpose(1, 2, 0)
    blocks = 0.5 * (blocks + blocks.transpose(0, 2, 1))

    # SPD block inversion (batched LAPACK); fall back per-element only if
    # some block is singular (an element whose entire boundary is
    # Dirichlet-free sees the constant through the coarse level instead)
    try:
        inv = np.linalg.inv(blocks)
    except np.linalg.LinAlgError:
        inv = np.zeros_like(blocks)
        for e in range(nelem):
            try:
                inv[e] = np.linalg.inv(blocks[e])
            except np.linalg.LinAlgError:
                inv[e] = np.linalg.pinv(blocks[e], rcond=1e-10)
    return jnp.asarray(inv, sem.dtype)


def block_apply(pblock_inv: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """z = E_ee^-1 r elementwise — one batched small matmul."""
    nelem, nloc = pblock_inv.shape[0], pblock_inv.shape[1]
    z = jnp.einsum("elk,ek->el", pblock_inv, r.reshape(nelem, nloc))
    return z.reshape(r.shape)


def face_adjacency(gid: np.ndarray):
    """Face-neighbor lists (share >= 2 global nodes, i.e. an edge/face —
    vertex-diagonal neighbors excluded), self NOT included."""
    E = gid.shape[0]
    flat = gid.reshape(E, -1)
    nodes = flat.reshape(-1)
    elem_of = np.repeat(np.arange(E), flat.shape[1])
    order = np.argsort(nodes, kind="stable")
    sn, se = nodes[order], elem_of[order]
    bnd = np.flatnonzero(np.diff(sn)) + 1
    starts = np.concatenate([[0], bnd])
    ends = np.concatenate([bnd, [sn.size]])
    from collections import Counter

    pair_counts: Counter = Counter()
    for s, e in zip(starts, ends):
        members = np.unique(se[s:e])
        for i in range(members.size):
            for j in range(i + 1, members.size):
                pair_counts[(int(members[i]), int(members[j]))] += 1
    nbrs = [[] for _ in range(E)]
    for (a, b), cnt in pair_counts.items():
        if cnt >= 2:
            nbrs[a].append(b)
            nbrs[b].append(a)
    return [sorted(x) for x in nbrs]


def build_pressure_patches(sem, E_op: Optional[Callable] = None,
                           weighted: bool = True,
                           B: Optional[dict] = None,
                           adjacency: str = "face"):
    """Overlapping element-patch Schwarz solves for the pressure operator.

    Patch of element e = e + its face neighbors; the patch matrix is the
    exact restriction of E (assembled from :func:`extract_sparse_E`) and is
    inverted host-side.  This is the JAX-native analogue of Nek5000's
    overlapping additive Schwarz pressure smoother (Fischer 1997): on
    stretched/graded meshes the overlap carries the inter-element edge
    modes that non-overlapping blocks miss (measured round 4: 309 -> ~x
    iterations on the Barkley BFS mesh).

    Returns (pidx, Pinv, w):
    pidx : (nelem, pdim) int32 indices into the flat pressure vector,
           padded with N (a dead slot)
    Pinv : (nelem, pdim, pdim) patch inverses (identity on pad slots)
    w    : (nelem, pdim) partition weights (1/count if ``weighted``, the
           symmetric-weighted additive Schwarz M = sum R^T W Pinv W R;
           ones = plain additive Schwarz).  Both SPD.
    """
    mesh = sem.mesh
    nelem = sem.nelem
    nloc = int(np.prod(sem.p_shape[1:]))
    N = nelem * nloc
    if B is None:
        B = extract_sparse_E(sem, E_op)
    gidf = np.asarray(mesh.gid).reshape(nelem, -1)
    if adjacency == "node":
        # full node-sharing patch (face + vertex-diagonal neighbors)
        adj = element_adjacency(gidf)
        members = [sorted(adj[e] - {e}) for e in range(nelem)]
        members = [[e] + m for e, m in enumerate(members)]
    else:
        nbrs = face_adjacency(gidf)
        members = [[e] + nbrs[e] for e in range(nelem)]
    pmax = max(len(m) for m in members)
    pdim = pmax * nloc

    pidx = np.full((nelem, pdim), N, dtype=np.int64)
    Pmats = np.zeros((nelem, pdim, pdim))
    counts = np.zeros(N)
    sizes = np.zeros(nelem, dtype=np.int64)
    for e, mem in enumerate(members):
        nm = len(mem)
        d = nm * nloc
        sizes[e] = d
        P = Pmats[e]
        for i, ei in enumerate(mem):
            for j, ej in enumerate(mem):
                blk = B.get((ei, ej))
                if blk is not None:
                    P[i * nloc:(i + 1) * nloc, j * nloc:(j + 1) * nloc] = blk
        idx = np.concatenate([np.arange(m * nloc, (m + 1) * nloc)
                              for m in mem])
        pidx[e, :d] = idx
        counts[idx] += 1.0
    # pad slots get an identity so the whole (nelem, pdim, pdim) batch
    # inverts in one LAPACK call (their rows are masked by w afterwards)
    ar = np.arange(pdim)
    for e in range(nelem):
        d = sizes[e]
        Pmats[e, ar[d:], ar[d:]] = 1.0
    Pmats = 0.5 * (Pmats + Pmats.transpose(0, 2, 1))
    try:
        Pinv = np.linalg.inv(Pmats)
    except np.linalg.LinAlgError:
        Pinv = np.zeros_like(Pmats)
        for e in range(nelem):
            try:
                Pinv[e] = np.linalg.inv(Pmats[e])
            except np.linalg.LinAlgError:
                Pinv[e] = np.linalg.pinv(Pmats[e], rcond=1e-10)
    w = np.ones((nelem, pdim))
    if weighted:
        cext = np.concatenate([counts, [1.0]])
        w = 1.0 / cext[pidx]
    w[pidx == N] = 0.0
    return (jnp.asarray(pidx, jnp.int32),
            jnp.asarray(Pinv, sem.dtype),
            jnp.asarray(w, sem.dtype))


def patch_apply(pidx: jnp.ndarray, Pinv: jnp.ndarray, w: jnp.ndarray,
                r: jnp.ndarray) -> jnp.ndarray:
    """z = sum_e R_e^T W_e Pinv_e W_e R_e r — gather, batched matmul,
    scatter-add."""
    N = r.size
    rf = jnp.concatenate([r.reshape(-1), jnp.zeros((1,), r.dtype)])
    rp = rf[pidx] * w
    z = jnp.einsum("eab,eb->ea", Pinv, rp) * w
    zf = jax.ops.segment_sum(z.reshape(-1), pidx.reshape(-1),
                             num_segments=N + 1)
    return zf[:N].reshape(r.shape)


def build_velocity_blocks(sem, h1: float, h2: float) -> jnp.ndarray:
    """Exact element-diagonal blocks of the ASSEMBLED velocity Helmholtz
    P (h1 K + h2 B) P per component (P = mask.dsavg.mask, the solve
    operator of ops/elliptic.py), inverted host-side.

    Same colored-extraction idea as the pressure blocks: the assembled
    operator couples only node-sharing neighbors, so one batched apply per
    (color, local-node) yields every diagonal block column.  The apply is
    one batched (nelem, n^d, n^d) matmul per component — no gather/scatter
    (round-4 sweep: apply cost, not iteration count, decided the capped-CG
    wall clock).

    Returns (ndim, nelem, nloc, nloc) block inverses.  ``h2`` is the
    g0/dt of the final BDF stage; the two ramp steps see a mismatched (up
    to ~1.8x) but still SPD preconditioner — CG convergence there is
    mildly slower, never wrong."""
    mesh = sem.mesh
    nelem = sem.nelem
    n = sem.n
    nloc = n ** sem.ndim
    fshape = tuple(int(s) for s in sem.bm.shape)
    colors = element_coupling_colors(np.asarray(mesh.gid).reshape(nelem, -1))
    ncol = int(colors.max()) + 1

    out = []
    for c_comp in range(sem.ndim):
        mask = sem.vmask[..., c_comp]

        def P(x):
            return mask * sem.dsavg(mask * x)

        def E_op(x):
            return P(sem.helmholtz_local(P(x), h1, h2))

        apply_batch = jax.jit(jax.vmap(E_op))
        blocks = np.zeros((nelem, nloc, nloc))
        for c in range(ncol):
            sel = colors == c
            basis = np.zeros((nloc, nelem, nloc))
            basis[np.arange(nloc)[:, None], sel,
                  np.arange(nloc)[:, None]] = 1.0
            res = np.asarray(apply_batch(
                jnp.asarray(basis.reshape((nloc,) + fshape), sem.dtype)
            )).reshape(nloc, nelem, nloc)
            blocks[sel] = res[:, sel].transpose(1, 2, 0)
        blocks = 0.5 * (blocks + blocks.transpose(0, 2, 1))
        # Dirichlet-masked rows/cols are zero -> put 1 on those diagonal
        # entries so the batch inverts (the apply re-masks through P)
        diag = np.einsum("eii->ei", blocks)
        dead = diag <= 0.0
        for e, k in zip(*np.nonzero(dead)):
            blocks[e, k, k] = 1.0
        try:
            inv = np.linalg.inv(blocks)
        except np.linalg.LinAlgError:
            inv = np.stack([np.linalg.pinv(b, rcond=1e-10) for b in blocks])
        out.append(inv)
    return jnp.asarray(np.stack(out), sem.dtype)


def velocity_block_apply(vblock_inv: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """z[..., c] = B_c^-1 r[..., c] elementwise — one batched matmul per
    component (r: (nelem, ..., ndim))."""
    nelem, nloc = vblock_inv.shape[1], vblock_inv.shape[2]
    rf = r.reshape(nelem, nloc, -1)
    z = jnp.einsum("celk,ekc->elc", vblock_inv, rf)
    return z.reshape(r.shape)


def build_p0_coarse(sem, B: Optional[dict] = None) -> np.ndarray:
    """Element-constant (P0) coarse operator for the discontinuous pressure
    space, assembled EXACTLY from the sparse blocks of E and inverted on
    the host.

    The pressure space is discontinuous P_{N-2}, so the indicator of each
    element is a genuine coarse basis function phi_e; the Galerkin coarse
    matrix  A_c[e,e'] = phi_e^T E phi_e' = sum of the (e,e') block  captures
    exactly the inter-element coupling the local solves cannot see — on
    graded meshes this adapts automatically because it is E itself, not a
    geometric rediscretization (the role Nek5000's XXT coarse solve plays,
    SURVEY.md section 2.2).  A_c is (nelem, nelem), dense-inverted
    host-side (pinv for the pure-Neumann constant nullspace).

    Returns the dense (nelem, nelem) coarse inverse as numpy."""
    if B is None:
        B = extract_sparse_E(sem)
    nelem = sem.nelem
    Ac = np.zeros((nelem, nelem))
    for (e, es), blk in B.items():
        Ac[e, es] = blk.sum()
    Ac = 0.5 * (Ac + Ac.T)
    if sem.has_pressure_dirichlet:
        return np.linalg.inv(Ac)
    return np.linalg.pinv(Ac, rcond=1e-12)


def _nearest_colored_source(mesh, colors: np.ndarray, c: int) -> np.ndarray:
    """For each element, the unique element of color ``c`` in its coupling
    patch (itself or a node-sharing neighbor), or -1 if none."""
    gid = np.asarray(mesh.gid)
    E = gid.shape[0]
    flat = gid.reshape(E, -1)
    nodes = flat.reshape(-1)
    elem_of = np.repeat(np.arange(E), flat.shape[1])
    order = np.argsort(nodes, kind="stable")
    sn, se = nodes[order], elem_of[order]
    bnd = np.flatnonzero(np.diff(sn)) + 1
    starts = np.concatenate([[0], bnd])
    ends = np.concatenate([bnd, [sn.size]])
    src = -np.ones(E, dtype=np.int64)
    sel = colors == c
    src[sel] = np.flatnonzero(sel)  # each colored element is its own source
    for s, e in zip(starts, ends):
        members = np.unique(se[s:e])
        colored = members[sel[members]]
        if colored.size == 1:
            src[members] = colored[0]
    return src


def p0_coarse_apply(Acinv: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """z = phi A_c^-1 phi^T r : restrict by element sums, dense coarse
    solve, prolong by broadcast."""
    nelem = Acinv.shape[0]
    rc = r.reshape(nelem, -1).sum(axis=1)
    xc = Acinv @ rc
    return (xc[:, None] + jnp.zeros_like(r.reshape(nelem, -1))).reshape(r.shape)
