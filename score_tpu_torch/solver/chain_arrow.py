"""Structure-exploiting KKT backend: chain + arrow factorization.

Port of :class:`score_tpu.solver.chain_arrow.ChainArrowBackend` (the f64
backend). The range-SLAM KKT matrix K = P + G'W^{-2}G has a fixed pattern:

  * distance variables couple only to their own cone/cost rows and the two
    endpoint translations -> eliminated per range in closed form;
  * pose blocks form per-robot chains coupled only by odometry
    (block-tridiagonal, D = d(d+1)-wide blocks);
  * landmarks, the translations of poses touched by pose-pose ranges and
    the full pose blocks of a vertex cover of the loop-closure graph form a
    dense "arrow" block coupled to the chains.

Per iteration: the chain band is factored and solved, the arrow panel
Z = T^{-1}B goes through the same band solve, and the dense arrow Schur
complement S - B'Z is a plain matmul followed by a Cholesky, all in the
problem's dtype. A float64 problem's band runs the f64 band kernels
(:mod:`score_tpu_torch.ops.band`: compacting CR down to one block); a float32
problem's (``precision="f32"``) runs cyclic reduction all the way down
(:mod:`score_tpu_torch.solver.pcr`) over the f32 block kernels, as the
JAX backend's non-two-float branch does.

Arrow column layout (host-chosen, static):

    [ landmarks | range-cover translations | loop-cover translations
      | loop-cover rotations ]

A stacked problem (``score_tpu_torch.parallel.stack_problems``: B trials
of one structure) runs through the same methods with a leading trial axis
on every per-trial quantity: ``prepare`` stacks the ``CAState`` fields
(never ``structure``, the one ``ChainArrowStructure`` passed in, whose
index tensors index the trials' tensors along their own axes and are never
expanded over the trials), and the band folds the trials into its chain
axis, (B*C, Tp, Db, Db), so that one launch of each band kernel (in
f32: each block kernel call of a cyclic reduction level) serves every
trial; its compaction depth follows Tp alone. The arrow Schur
complement is (B, A, A), factored by one batched ``cholesky_ex`` with the
escalated retry selected lane by lane on the device (:func:`lane_cholesky`).
On a single problem every method runs the ops it always did.

A structure with a ``shard`` (``score_tpu_torch.parallel.
solve_conic_chain_sharded``) splits the chain axis over the ranks of a
``torch.distributed`` group: every rank holds the problem, the state and
the arrow, factors and solves only its own chains, and completes three
sums over the group, each an ``all_reduce``: the arrow Schur complement's
B'Z, the arrow rhs's B'w and the chain solution.

Not carried over from the JAX backend: the two-float band and its Jacobi
equilibration (the card has native f64), the blocked arrow Cholesky and
the split-f32 matmuls (TPU f64 workarounds) and SPIKE segmentation
(chains stay in device memory).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from score_tpu_torch.assembly.conic import (
    ConicProblem,
    SOCP_RELAXATION,
    VariableIndex,
)
from score_tpu_torch.ops.band import BandFactors, band_factor, band_solve, pad_length
from score_tpu_torch.solver.collective import all_reduce
from score_tpu_torch.solver.linops import (
    G_apply,
    batch_shape,
    cost_constant,
    cost_q,
    free_mask,
    pin_vector,
    trial_norm,
)
from score_tpu_torch.solver.pcr import PCRFactors, pcr_factor, pcr_solve
from score_tpu_torch.solver.smallblocks import inv_small_spd

__all__ = [
    "ChainArrowStructure",
    "build_chain_arrow",
    "ChainArrowBackend",
    "CAState",
    "CAFactors",
    "ChainShard",
    "lane_cholesky",
]

# ------------------------------------------------------------------ #
# Host-side structure analysis
# ------------------------------------------------------------------ #


@dataclasses.dataclass(frozen=True)
class ChainArrowStructure:
    """Static structure (index maps, masks) for the backend, on the
    problem's device, the masks in its dtype. Canonical "struct" layout of
    x: [pose slots (C*T*D) | landmarks (NL*d) | distances (NR*ds)]."""

    cm: torch.Tensor  # (C, T, D) chain-active column mask
    av: torch.Tensor  # (C, T, D) arrow-resident column mask
    arrow_col: torch.Tensor  # (C, T, D) arrow column of entry, A = none
    arrow_src: torch.Tensor  # (A,) into [slots.flat | landmarks.flat]
    x_to_chain: torch.Tensor  # (C, T, D) gather: padded x -> pose slots
    x_to_lm: torch.Tensor  # (NL, d)
    x_to_dist: torch.Tensor  # (NR, ds)
    struct_to_x: torch.Tensor  # (n,) gather from flat struct -> x
    odom_row_base: torch.Tensor  # (C, T-1) (clamped; odom_valid masks pads)
    odom_valid: torch.Tensor  # (C, T-1)
    odom_local_onehot: torch.Tensor  # (D_rows, nnz, 2D+1)
    loop_row_base: torch.Tensor  # (NLC,)
    loop_slot_i: torch.Tensor  # (NLC,) flat slot (c*T + t)
    loop_slot_j: torch.Tensor  # (NLC,)
    range_row_base: torch.Tensor  # (NR,)
    end_a_cols: torch.Tensor  # (NR, d) x cols of endpoint-a translation
    end_b_cols: torch.Tensor  # (NR, d)
    # degree-padded incidence lists: `pose_inc`/`lm_inc` index the
    # concatenation [ga; gb; zero-row] (endpoint-b entries offset by NR,
    # pad = 2*NR); `chain_inc` holds the measurement index m (pad = NR) and
    # `chain_other` the arrow site of m's other endpoint (pad = NTB)
    pose_inc: torch.Tensor  # (C*T, Kp)
    lm_inc: torch.Tensor  # (max(NL,1), Kl)
    chain_inc: torch.Tensor  # (C*T, Kc)
    chain_other: torch.Tensor  # (C*T, Kc)
    # translation-zone arrow site of each range endpoint, NTB when the
    # endpoint is chain-resident (the JAX backend stores these one-hot)
    site_a: torch.Tensor  # (NR,)
    site_b: torch.Tensor  # (NR,)
    prior_diag_sites: torch.Tensor  # (NPp,) landmark site of each prior
    prior_row_base: torch.Tensor  # (NPp,)
    C: int
    T: int
    D: int
    d: int
    NL: int
    NTB: int  # translation-zone sites
    A: int  # arrow width
    NR: int
    NLC: int
    ds: int
    relaxation: str
    # intra-problem sharding (score_tpu_torch.parallel.intra): this rank's
    # share of the chain axis. The rank factors and solves only its chains
    # and the backend sums the arrow Schur complement, the arrow rhs and
    # the chain solution over the group; None: one process holds them all
    shard: Optional["ChainShard"] = None


class ChainShard(NamedTuple):
    """A process group over which the chain axis is split: rank ``rank`` of
    ``world`` owns chains [rank * C / world, (rank + 1) * C / world) of a
    structure whose C the world size divides (``torch.distributed``
    ``group``; None is the default group)."""

    group: object
    rank: int
    world: int

    def chains(self, C: int) -> slice:
        if C % self.world:
            raise ValueError(f"{C} chains do not split over {self.world} ranks; pad the "
                             "chain axis (build_chain_arrow(..., num_chains_pad=))")
        per = C // self.world
        return slice(self.rank * per, (self.rank + 1) * per)


def _greedy_cover(edges, excluded):
    """Greedy max-degree vertex cover of `edges`; nodes in `excluded` are
    treated as already covered (the pinned pose: its couplings vanish)."""
    degree: dict = {}
    for a, b in edges:
        degree[a] = degree.get(a, 0) + 1
        degree[b] = degree.get(b, 0) + 1
    cover = set()
    for a, b in sorted(edges, key=lambda e: -(degree[e[0]] + degree[e[1]])):
        if a in excluded or b in excluded:
            continue
        if a not in cover and b not in cover:
            cover.add(a if degree[a] >= degree[b] else b)
    return cover


def _pack_incidence(rows, vals, n_rows, pad, extra=None, extra_pad=0):
    """Pack (row, val[, extra]) entry lists into degree-padded
    (n_rows, Kmax) tables; Kmax = max per-row multiplicity (>= 1)."""
    rows = np.asarray(rows, dtype=np.int64).reshape(-1)
    vals = np.asarray(vals, dtype=np.int64).reshape(-1)
    if rows.size == 0:
        out = np.full((n_rows, 1), pad, dtype=np.int64)
        if extra is None:
            return out
        return out, np.full((n_rows, 1), extra_pad, dtype=np.int64)
    counts = np.bincount(rows, minlength=n_rows)
    K = int(counts.max())
    order = np.argsort(rows, kind="stable")
    r = rows[order]
    starts = np.zeros(n_rows + 1, dtype=np.int64)
    starts[1:] = np.cumsum(counts)
    pos = np.arange(r.size) - starts[r]
    out = np.full((n_rows, K), pad, dtype=np.int64)
    out[r, pos] = vals[order]
    if extra is None:
        return out
    extra = np.asarray(extra, dtype=np.int64).reshape(-1)
    out2 = np.full((n_rows, K), extra_pad, dtype=np.int64)
    out2[r, pos] = extra[order]
    return out, out2


def build_chain_arrow(problem: ConicProblem, idx: VariableIndex,
                      num_chains_pad: int = 0) -> ChainArrowStructure:
    """Host-side (numpy) structure analysis; the result lives on the
    problem's device, its float masks in the problem's dtype.

    ``num_chains_pad`` rounds the chain axis up to that many chains with
    fully inactive ones (cm = av = 0, no coupling, identity diagonal), so
    that it splits over the ranks of an intra-problem sharded solve
    (``score_tpu/solver/chain_arrow.py:196-209``)."""
    d = idx.dim
    D = idx.pose_block
    C = max(len(idx.chain_lengths), num_chains_pad)
    T = max(idx.chain_lengths)
    NR = idx.num_ranges
    NL = idx.num_landmarks
    ds = idx.dist_size
    n = problem.n

    pose_cpos = {}
    g = 0
    for c, ln in enumerate(idx.chain_lengths):
        for t in range(ln):
            pose_cpos[g] = (c, t)
            g += 1
    name_to_pose = {nm: i for i, nm in enumerate(idx.pose_names)}
    name_to_lm = {nm: i for i, nm in enumerate(idx.landmark_names)}

    pin_cols = set(int(v) for v in problem.pin_idx.cpu().numpy())
    pinned_poses = {col // D for col in pin_cols if col < idx.landmark_offset}
    fully_pinned = {
        p for p in pinned_poses if all(p * D + k in pin_cols for k in range(D))
    }

    # --- loop-closure cover: one endpoint's WHOLE pose into the arrow ---
    loop_pairs = [(name_to_pose[a], name_to_pose[b]) for (a, b) in idx.loop_pairs]
    loop_cover = _greedy_cover(loop_pairs, fully_pinned)

    # --- range cover: one endpoint's TRANSLATION into the arrow -------
    pp_edges = [
        (name_to_pose[a], name_to_pose[b])
        for (a, b) in idx.dist_keys
        if a in name_to_pose and b in name_to_pose
    ]
    range_cover = _greedy_cover(
        [e for e in pp_edges if e[0] not in loop_cover and e[1] not in loop_cover],
        fully_pinned | loop_cover,
    )
    range_cover -= loop_cover

    # --- arrow layout ---------------------------------------------------
    rc_poses = sorted(range_cover)
    lp_poses = sorted(loop_cover)
    NRC, NLP = len(rc_poses), len(lp_poses)
    NTB = NL + NRC + NLP
    tz = NTB * d
    A = tz + NLP * d * d
    A_eff = max(A, 1)
    tsite_of_pose = {p: NL + i for i, p in enumerate(rc_poses)}
    tsite_of_pose.update({p: NL + NRC + i for i, p in enumerate(lp_poses)})
    rotbase_of_pose = {p: tz + i * d * d for i, p in enumerate(lp_poses)}

    # --- residency maps ---------------------------------------------------
    cm = np.zeros((C, T, D))
    av = np.zeros((C, T, D))
    arrow_col = np.full((C, T, D), A_eff, dtype=np.int64)
    x_to_chain = np.full((C, T, D), n, dtype=np.int64)
    arrow_src = np.full((A_eff,), C * T * D + NL * d, dtype=np.int64)  # pad
    for g, (c, t) in pose_cpos.items():
        cols = np.arange(g * D, g * D + D)
        x_to_chain[c, t] = cols
        cm[c, t] = 1.0
        slot_flat = (c * T + t) * D
        if g in loop_cover:
            cm[c, t] = 0.0
            av[c, t] = 1.0
            for k in range(d * d):
                a = rotbase_of_pose[g] + k
                arrow_col[c, t, k] = a
                arrow_src[a] = slot_flat + k
            for r in range(d):
                a = tsite_of_pose[g] * d + r
                arrow_col[c, t, d * d + r] = a
                arrow_src[a] = slot_flat + d * d + r
        elif g in range_cover:
            cm[c, t, d * d:] = 0.0
            av[c, t, d * d:] = 1.0
            for r in range(d):
                a = tsite_of_pose[g] * d + r
                arrow_col[c, t, d * d + r] = a
                arrow_src[a] = slot_flat + d * d + r
        for k_, col in enumerate(cols):
            if col in pin_cols:
                cm[c, t, k_] = 0.0
                av[c, t, k_] = 0.0
                arrow_col[c, t, k_] = A_eff
    for l in range(NL):
        for r in range(d):
            arrow_src[l * d + r] = C * T * D + l * d + r

    x_to_lm = np.stack(
        [np.asarray(idx.landmark_cols(l), dtype=np.int64) for l in range(NL)]
    ) if NL else np.zeros((0, d), dtype=np.int64)
    x_to_dist = np.stack(
        [np.asarray(idx.dist_cols(m), dtype=np.int64) for m in range(NR)]
    ) if NR else np.zeros((0, ds), dtype=np.int64)

    # struct -> x permutation
    struct_len = C * T * D + NL * d + NR * ds
    struct_to_x = np.full((n,), struct_len, dtype=np.int64)
    for flat_pos, xcol in enumerate(x_to_chain.reshape(-1)):
        if xcol < n:
            struct_to_x[xcol] = flat_pos
    off = C * T * D
    for flat_pos, xcol in enumerate(x_to_lm.reshape(-1)):
        struct_to_x[xcol] = off + flat_pos
    off += NL * d
    for flat_pos, xcol in enumerate(x_to_dist.reshape(-1)):
        struct_to_x[xcol] = off + flat_pos

    # --- cost-row bases (emission order: odometry chains flattened, loop
    # closures, ranges, landmark priors — assembly/conic.py) -------------
    rows_per_edge = d * d + d
    NLC = len(loop_pairs)
    odom_row_base = np.zeros((C, max(T - 1, 1)), dtype=np.int64)
    odom_valid = np.zeros((C, max(T - 1, 1)))
    e = 0
    for c, ln in enumerate(idx.chain_lengths):
        for t in range(ln - 1):
            odom_row_base[c, t] = e * rows_per_edge
            odom_valid[c, t] = 1.0
            e += 1
    loop_row_base = (e + np.arange(NLC, dtype=np.int64)) * rows_per_edge
    loop_slot_i = np.zeros((NLC,), dtype=np.int64)
    loop_slot_j = np.zeros((NLC,), dtype=np.int64)
    for m, (pi, pj) in enumerate(loop_pairs):
        ci, ti = pose_cpos[pi]
        cj, tj = pose_cpos[pj]
        loop_slot_i[m] = ci * T + ti
        loop_slot_j[m] = cj * T + tj
    range_rows_start = (e + NLC) * rows_per_edge
    rows_per_range = 1 if idx.relaxation == SOCP_RELAXATION else d
    range_row_base = range_rows_start + np.arange(NR, dtype=np.int64) * rows_per_range
    prior_rows_start = range_rows_start + NR * rows_per_range
    n_priors = (int(problem.cost_b.shape[0]) - prior_rows_start) // d
    prior_row_base = prior_rows_start + np.arange(n_priors, dtype=np.int64) * d
    prior_diag_sites = np.zeros((n_priors,), dtype=np.int64)
    cost_cols_np = problem.cost_cols.cpu().numpy()
    for j in range(n_priors):
        col = int(cost_cols_np[prior_row_base[j], 0])
        prior_diag_sites[j] = (col - idx.landmark_offset) // d

    # --- range endpoint maps (vectorized over the NR ranges) -------------
    end_a_cols = np.full((NR, d), n, dtype=np.int64)
    end_b_cols = np.full((NR, d), n, dtype=np.int64)
    site_a = np.full((NR,), NTB, dtype=np.int64)
    site_b = np.full((NR,), NTB, dtype=np.int64)

    pose_rows: list = []
    pose_vals: list = []
    lm_rows_l: list = []
    lm_vals: list = []
    chain_rows: list = []
    chain_vals: list = []
    chain_oth: list = []
    if NR:
        slot_of_pose = np.full(max(len(pose_cpos), 1), -1, dtype=np.int64)
        tsite_arr = np.full(max(len(pose_cpos), 1), -1, dtype=np.int64)
        for g, (c, t) in pose_cpos.items():
            slot_of_pose[g] = c * T + t
        for p_, site in tsite_of_pose.items():
            tsite_arr[p_] = site
        m_idx = np.arange(NR)
        side_site = []  # arrow site of each side's endpoint, -1 if chain
        side_data = []
        for keys_pos, ec, sites in ((0, end_a_cols, site_a), (1, end_b_cols, site_b)):
            names = [key[keys_pos] for key in idx.dist_keys]
            ec[:] = np.stack([idx.translation_cols(nm) for nm in names])
            is_pose = np.array([nm in name_to_pose for nm in names])
            unknown = [
                nm for nm in names if nm not in name_to_pose and nm not in name_to_lm
            ]
            if unknown:
                raise KeyError(
                    f"range endpoint(s) {sorted(set(unknown))} are neither "
                    "pose nor landmark names"
                )
            pidx_v = np.array([name_to_pose.get(nm, 0) for nm in names], dtype=np.int64)
            lidx_v = np.array(
                [name_to_lm.get(nm, 0) if nm not in name_to_pose else 0 for nm in names],
                dtype=np.int64,
            )
            lm_rows = m_idx[~is_pose]
            sites[lm_rows] = lidx_v[~is_pose]
            p_rows = m_idx[is_pose]
            p_sel = pidx_v[is_pose]
            in_arrow = tsite_arr[p_sel] >= 0
            sites[p_rows[in_arrow]] = tsite_arr[p_sel[in_arrow]]

            pose_rows.append(slot_of_pose[p_sel])
            pose_vals.append(keys_pos * NR + p_rows)
            lm_rows_l.append(lidx_v[~is_pose])
            lm_vals.append(keys_pos * NR + lm_rows)
            site = np.full(NR, -1, dtype=np.int64)
            site[~is_pose] = lidx_v[~is_pose]
            site[p_rows[in_arrow]] = tsite_arr[p_sel[in_arrow]]
            side_site.append(site)
            side_data.append((p_rows, p_sel, in_arrow))
        for s, (p_rows, p_sel, in_arrow) in enumerate(side_data):
            ch_m = p_rows[~in_arrow]  # chain-resident endpoints
            other = side_site[1 - s][ch_m]
            # both endpoints chain-resident only when one is the pinned
            # pose: route the (vanishing) cross term to the pad site
            other = np.where(other < 0, max(NTB, 1), other)
            chain_rows.append(slot_of_pose[p_sel[~in_arrow]])
            chain_vals.append(ch_m)
            chain_oth.append(other)

    pose_inc = _pack_incidence(
        np.concatenate(pose_rows) if pose_rows else [],
        np.concatenate(pose_vals) if pose_vals else [],
        C * T, pad=2 * NR,
    )
    lm_inc = _pack_incidence(
        np.concatenate(lm_rows_l) if lm_rows_l else [],
        np.concatenate(lm_vals) if lm_vals else [],
        max(NL, 1), pad=2 * NR,
    )
    chain_inc, chain_other = _pack_incidence(
        np.concatenate(chain_rows) if chain_rows else [],
        np.concatenate(chain_vals) if chain_vals else [],
        C * T, pad=NR,
        extra=np.concatenate(chain_oth) if chain_oth else [],
        extra_pad=max(NTB, 1),
    )

    # --- relative-pose local-position one-hot (local pose layout
    # col-major [R | t], pose_i at 0..D-1, pose_j at D..2D-1, slot 2D =
    # trash for padding) ------------------------------------------------
    nnz = int(problem.cost_cols.shape[1])
    local_pos = np.full((rows_per_edge, nnz), 2 * D, dtype=np.int64)
    for c in range(d):
        for r in range(d):
            row = c * d + r
            local_pos[row, 0] = D + c * d + r
            for kk in range(d):
                local_pos[row, 1 + kk] = kk * d + r
    for r in range(d):
        row = d * d + r
        local_pos[row, 0] = D + d * d + r
        local_pos[row, 1] = d * d + r
        for kk in range(d):
            local_pos[row, 2 + kk] = kk * d + r
    odom_local_onehot = np.zeros((rows_per_edge, nnz, 2 * D + 1))
    for row in range(rows_per_edge):
        for jj in range(nnz):
            odom_local_onehot[row, jj, local_pos[row, jj]] = 1.0

    dev = problem.device

    def farr(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev).to(problem.dtype)

    def iarr(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

    return ChainArrowStructure(
        cm=farr(cm), av=farr(av), arrow_col=iarr(arrow_col),
        arrow_src=iarr(arrow_src), x_to_chain=iarr(x_to_chain),
        x_to_lm=iarr(x_to_lm), x_to_dist=iarr(x_to_dist),
        struct_to_x=iarr(struct_to_x), odom_row_base=iarr(odom_row_base),
        odom_valid=farr(odom_valid), odom_local_onehot=farr(odom_local_onehot),
        loop_row_base=iarr(loop_row_base), loop_slot_i=iarr(loop_slot_i),
        loop_slot_j=iarr(loop_slot_j), range_row_base=iarr(range_row_base),
        end_a_cols=iarr(end_a_cols), end_b_cols=iarr(end_b_cols),
        pose_inc=iarr(pose_inc), lm_inc=iarr(lm_inc),
        chain_inc=iarr(chain_inc), chain_other=iarr(chain_other),
        site_a=iarr(site_a), site_b=iarr(site_b),
        prior_diag_sites=iarr(prior_diag_sites),
        prior_row_base=iarr(prior_row_base),
        C=C, T=T, D=D, d=d, NL=NL, NTB=NTB, A=A_eff, NR=NR, NLC=NLC,
        ds=ds, relaxation=idx.relaxation,
    )


# ------------------------------------------------------------------ #
# Device-side state
# ------------------------------------------------------------------ #


@dataclasses.dataclass(frozen=True)
class CAState:
    """Per-solve prepared quantities (q/const/mask/xpin/hnorm/qnorm are the
    solver's backend-state contract)."""

    structure: ChainArrowStructure
    q: torch.Tensor
    const: torch.Tensor
    mask: torch.Tensor
    xpin: torch.Tensor
    hnorm: torch.Tensor
    qnorm: torch.Tensor
    edge_ii: torch.Tensor  # (C, T-1, D, D) odometry edge blocks (P side)
    edge_ij: torch.Tensor
    edge_jj: torch.Tensor
    loop_ii: torch.Tensor  # (NLC, D, D) loop-closure edge blocks
    loop_ij: torch.Tensor
    loop_jj: torch.Tensor
    D0: torch.Tensor  # (C, T, D, D) chain diag base (chain-masked)
    U0: torch.Tensor  # (C, T-1, D, D) chain off-diag (chain-masked)
    B0: torch.Tensor  # (C, T, D, A) chain-arrow base coupling
    S0: torch.Tensor  # (A, A) arrow base (odometry/loop spill + priors)
    prior_diag: torch.Tensor  # (NL*d,) 2*precision on prior landmark cols
    rng_prec: torch.Tensor  # (NR,)
    rng_dist: torch.Tensor  # (NR,)


class CAFactors(NamedTuple):
    # factors of the padded chain band: BandFactors (CR + PCR kernels) for
    # f64, PCRFactors (cyclic reduction) for f32
    band: BandFactors | PCRFactors
    B: torch.Tensor  # (C, Tp, D, A) masked chain-arrow coupling
    Z: torch.Tensor  # (C, Tp, D, A) = T^{-1} B
    LS: torch.Tensor  # (A, A) arrow Schur Cholesky
    kdd: torch.Tensor  # SOCP (NR,) pivots; QCQP (NR,d,d) pivot inverses
    wv: torch.Tensor  # SOCP (NR,d) coupling vectors; QCQP zeros
    Hhat: torch.Tensor  # (NR, d, d)
    Winv2: torch.Tensor  # (NR, k, k) NT scalings (for refinement matvecs)


def _scatter_add(out: torch.Tensor, index: tuple, values: torch.Tensor,
                 lead: tuple = ()) -> None:
    """out[index] += values with repeated indices accumulating (the JAX
    ``.at[index].add``): the index tensors broadcast against each other to
    a shape S, and values broadcast to S + out.shape[len(index):], the
    shape of ``out[index]``. (Index tensors for fewer dimensions than
    ``out`` has select whole sub-blocks: the loop closures' D x D blocks
    and D-vectors.) With ``lead`` trial axes leading both ``out`` and
    ``values``, the index applies to the dimensions after them in every
    trial: the trial axes move behind the indexed ones in a view, so that
    the index tensors are used as they are."""
    shape = torch.broadcast_shapes(*(i.shape for i in index))
    if lead:
        nl, ni = len(lead), len(index)
        rest = out.shape[nl + ni:]
        view = out.movedim(tuple(range(nl)), tuple(range(ni, ni + nl)))
        vals = values.expand(lead + shape + rest).movedim(
            tuple(range(nl)), tuple(range(len(shape), len(shape) + nl)))
        view.index_put_(tuple(i.expand(shape) for i in index), vals, accumulate=True)
        return
    target = shape + out.shape[len(index):]
    out.index_put_(
        tuple(i.expand(shape) for i in index), values.expand(target),
        accumulate=True,
    )


class ChainArrowBackend:
    """KKT backend exploiting the SLAM chain+arrow structure. Use via
    ``solve_conic(problem, params, backend=ChainArrowBackend,
    backend_aux=build_chain_arrow(problem, idx))``."""

    # ---------------- struct layout helpers ---------------- #

    @staticmethod
    def _gather(state: CAState, v):
        st = state.structure
        vp = torch.cat([v, v.new_zeros(v.shape[:-1] + (1,))], dim=-1)
        return vp[..., st.x_to_chain], vp[..., st.x_to_lm], vp[..., st.x_to_dist]

    @staticmethod
    def _to_x(state: CAState, vc, vl, vd):
        st = state.structure
        lead = vc.shape[:-3]
        flat = torch.cat(
            [vc.reshape(lead + (-1,)), vl.reshape(lead + (-1,)), vd.reshape(lead + (-1,)),
             vc.new_zeros(lead + (1,))], dim=-1,
        )
        return flat[..., st.struct_to_x]

    @staticmethod
    def _range_endpoint_values(state: CAState, v):
        """(ta, tb) translations of each range's endpoints from x."""
        st = state.structure
        vp = torch.cat([v, v.new_zeros(v.shape[:-1] + (1,))], dim=-1)
        return vp[..., st.end_a_cols], vp[..., st.end_b_cols]

    @staticmethod
    def _range_endpoint_adjoint(state: CAState, ga, gb):
        """Accumulate per-range endpoint gradients (NR, d) onto the pose-
        slot layout (C, T, D) and landmark layout (NL, d) by degree-padded
        gather + sum over the incidence lists."""
        st = state.structure
        d, D = st.d, st.D
        lead = ga.shape[:-2]
        gab = torch.cat([ga, gb, ga.new_zeros(lead + (1, d))], dim=-2)
        tr = torch.sum(gab[..., st.pose_inc, :], dim=-2)  # (C*T, d)
        vc = ga.new_zeros(lead + (st.C * st.T, D))
        vc[..., d * d:] = tr
        vl = torch.sum(gab[..., st.lm_inc, :], dim=-2)
        return vc.reshape(lead + (st.C, st.T, D)), vl[..., : st.NL, :]

    # ---------------- prepare ---------------- #

    @staticmethod
    def _edge_blocks(problem, st, row_base):
        """Relative-pose cost blocks 2 A_loc' diag(w) A_loc from the row
        encoding; row_base (...,) gives each edge's first row."""
        D = st.D
        row_idx = row_base[..., None] + torch.arange(D, device=row_base.device)
        coefs = problem.cost_coefs[..., row_idx, :]  # (..., D, nnz)
        w = problem.cost_w[..., row_idx]
        A_loc = torch.einsum("...rj,rjl->...rl", coefs, st.odom_local_onehot)[..., : 2 * D]
        M = 2.0 * torch.einsum("...rl,...r,...rm->...lm", A_loc, w, A_loc)
        return M[..., :D, :D], M[..., :D, D:], M[..., D:, D:]

    @staticmethod
    def prepare(problem: ConicProblem, aux: ChainArrowStructure) -> CAState:
        st = aux
        dev = problem.device
        C, T, D, d, A = st.C, st.T, st.D, st.d, st.A
        dt = problem.dtype
        lead = batch_shape(problem)  # (B,) for stacked trials
        nl = lead  # the trial axes a scatter passes over

        q = cost_q(problem)

        # odometry edge blocks (batched matmuls)
        eii, eij, ejj = ChainArrowBackend._edge_blocks(problem, st, st.odom_row_base)
        ov = st.odom_valid[..., None, None]
        edge_ii, edge_ij, edge_jj = eii * ov, eij * ov, ejj * ov

        if st.NLC:
            loop_ii, loop_ij, loop_jj = ChainArrowBackend._edge_blocks(
                problem, st, st.loop_row_base
            )
        else:
            loop_ii = loop_ij = loop_jj = torch.zeros(lead + (0, D, D), dtype=dt, device=dev)

        cm_f = st.cm.reshape(C * T, D)
        av_f = st.av.reshape(C * T, D)
        ac_f = st.arrow_col.reshape(C * T, D)

        # chain-band pieces
        cm_i, cm_j = st.cm[:, :-1], st.cm[:, 1:]
        D0 = torch.zeros(lead + (C, T, D, D), dtype=dt, device=dev)
        D0[..., :-1, :, :] += edge_ii[..., : T - 1, :, :] * cm_i[..., :, None] * cm_i[..., None, :]
        D0[..., 1:, :, :] += edge_jj[..., : T - 1, :, :] * cm_j[..., :, None] * cm_j[..., None, :]
        U0 = edge_ij[..., : T - 1, :, :] * cm_i[..., :, None] * cm_j[..., None, :]

        # static arrow couplings, scattered once per solve. B0 has a pad
        # column (index A) and S0 a pad row/col for non-arrow entries.
        B0p = torch.zeros(lead + (C * T, D, A + 1), dtype=dt, device=dev)
        S0p = torch.zeros(lead + (A + 1, A + 1), dtype=dt, device=dev)
        l_idx = torch.arange(D, device=dev)[None, :, None]

        def add_coupling(D0f, blk, su, sv):
            """blk (E, D, D): rows at flat slots su, cols at slots sv."""
            cmu, avu, acu = cm_f[su], av_f[su], ac_f[su]
            cmv, avv, acv = cm_f[sv], av_f[sv], ac_f[sv]
            _scatter_add(B0p, (su[:, None, None], l_idx, acv[:, None, :]),
                         blk * cmu[:, :, None] * avv[:, None, :], nl)
            _scatter_add(S0p, (acu[:, :, None], acv[:, None, :]),
                         blk * avu[:, :, None] * avv[:, None, :], nl)
            # same-slot chain x chain (loop endpoints; odometry diagonals
            # are handled densely above)
            if D0f is not None:
                _scatter_add(D0f, (su,), blk * cmu[:, :, None] * cmv[:, None, :], nl)

        # odometry spill into the arrow (skipped when no pose has arrow
        # residency, e.g. robot-landmark ranges only)
        has_arrow_poses = (st.NTB > st.NL) or st.NLC > 0
        if has_arrow_poses and T > 1:
            slots = torch.arange(C * T, device=dev).reshape(C, T)
            si = slots[:, :-1].reshape(-1)
            sj = slots[:, 1:].reshape(-1)
            vmask = st.odom_valid.reshape(-1)[:, None, None]
            bii = edge_ii.reshape(lead + (-1, D, D)) * vmask
            bij = edge_ij.reshape(lead + (-1, D, D)) * vmask
            bjj = edge_jj.reshape(lead + (-1, D, D)) * vmask
            add_coupling(None, bii, si, si)
            add_coupling(None, bjj, sj, sj)
            add_coupling(None, bij, si, sj)
            add_coupling(None, bij.transpose(-1, -2), sj, si)

        # loop-closure couplings (the cover guarantees no cross-slot
        # chain x chain term; same-slot chain x chain goes to D0)
        D0f = D0.reshape(lead + (C * T, D, D))
        if st.NLC:
            si, sj = st.loop_slot_i, st.loop_slot_j
            add_coupling(D0f, loop_ii, si, si)
            add_coupling(D0f, loop_jj, sj, sj)
            add_coupling(D0f, loop_ij, si, sj)
            add_coupling(D0f, loop_ij.transpose(-1, -2), sj, si)

        B0 = B0p[..., :A].reshape(lead + (C, T, D, A))
        S0 = S0p[..., :A, :A].clone()

        # landmark priors on the arrow diagonal (landmark sites lead)
        prior_diag = torch.zeros(lead + (st.NL * d,), dtype=dt, device=dev)
        if st.prior_row_base.shape[0] > 0:
            pw = 2.0 * problem.cost_w[..., st.prior_row_base]
            site_oh = (
                st.prior_diag_sites[:, None] == torch.arange(st.NL, device=dev)[None, :]
            ).to(dt)
            per_lm = torch.einsum("pl,...p->...l", site_oh, pw)
            prior_diag = torch.repeat_interleave(per_lm, d, dim=-1)
            S0 = S0 + torch.diag_embed(
                torch.cat([prior_diag, prior_diag.new_zeros(lead + (A - st.NL * d,))], dim=-1)
            )

        # range numeric data
        if st.NR > 0:
            rng_prec = problem.cost_w[..., st.range_row_base]
            if st.relaxation == SOCP_RELAXATION:
                rng_dist = problem.cost_b[..., st.range_row_base]
            else:
                rng_dist = -problem.cost_coefs[..., st.range_row_base, 2]
        else:
            rng_prec = rng_dist = torch.zeros(lead + (0,), dtype=dt, device=dev)

        one = torch.ones((), dtype=dt, device=dev)
        return CAState(
            structure=st, q=q, const=cost_constant(problem), mask=free_mask(problem),
            xpin=pin_vector(problem),
            hnorm=torch.maximum(one, trial_norm(problem.cone_h, lead)),
            qnorm=torch.maximum(one, trial_norm(q, lead)),
            edge_ii=edge_ii, edge_ij=edge_ij, edge_jj=edge_jj,
            loop_ii=loop_ii, loop_ij=loop_ij, loop_jj=loop_jj,
            D0=D0, U0=U0, B0=B0, S0=S0, prior_diag=prior_diag,
            rng_prec=rng_prec, rng_dist=rng_dist,
        )

    # ---------------- operator applications ---------------- #

    @staticmethod
    def P_matvec(state: CAState, v):
        st = state.structure
        d = st.d
        vc, vl, vd = ChainArrowBackend._gather(state, v)
        # The relative-pose blocks carry the large rotation weights: their
        # two products per edge are orders of magnitude larger than their
        # sum, and an f32 evaluation leaves the dual residual at the f32
        # mode's reduced tolerance (1e-2). So the edge products accumulate
        # in f64 and round once to the problem's dtype (a no-op for f64).
        wide = torch.float64

        lead = v.shape[:-1]

        # odometry
        vi, vj = vc[..., :-1, :].to(wide), vc[..., 1:, :].to(wide)
        ei, ej, ejj = (e[..., : st.T - 1, :, :].to(wide)
                       for e in (state.edge_ii, state.edge_ij, state.edge_jj))
        oi = (torch.einsum("...ctlm,...ctm->...ctl", ei, vi)
              + torch.einsum("...ctlm,...ctm->...ctl", ej, vj))
        oj = (torch.einsum("...ctml,...ctm->...ctl", ej, vi)
              + torch.einsum("...ctlm,...ctm->...ctl", ejj, vj))
        out_c = torch.zeros_like(vc)
        out_c[..., :-1, :] += oi.to(vc.dtype)
        out_c[..., 1:, :] += oj.to(vc.dtype)

        # loop closures (few edges: gather endpoints, blocked matvecs,
        # small scatter-add back)
        if st.NLC:
            vflat = vc.reshape(lead + (st.C * st.T, st.D))
            li = vflat[..., st.loop_slot_i, :].to(wide)
            lj = vflat[..., st.loop_slot_j, :].to(wide)
            lii, lij, ljj = (e.to(wide) for e in (state.loop_ii, state.loop_ij, state.loop_jj))
            gi = (torch.einsum("...elm,...em->...el", lii, li)
                  + torch.einsum("...elm,...em->...el", lij, lj))
            gj = (torch.einsum("...eml,...em->...el", lij, li)
                  + torch.einsum("...elm,...em->...el", ljj, lj))
            oflat = torch.zeros_like(vflat)
            _scatter_add(oflat, (st.loop_slot_i,), gi.to(vc.dtype), lead)
            _scatter_add(oflat, (st.loop_slot_j,), gj.to(vc.dtype), lead)
            out_c = out_c + oflat.reshape(lead + (st.C, st.T, st.D))

        # ranges
        out_d = torch.zeros_like(vd)
        out_l = torch.zeros_like(vl)
        if st.NR:
            if st.relaxation == SOCP_RELAXATION:
                out_d = 2.0 * state.rng_prec[..., None] * vd
            else:
                ta, tb = ChainArrowBackend._range_endpoint_values(state, v)
                r = ta - tb - state.rng_dist[..., None] * vd
                w2 = 2.0 * state.rng_prec[..., None]
                gc, gl = ChainArrowBackend._range_endpoint_adjoint(state, w2 * r, -w2 * r)
                out_c = out_c + gc
                out_l = out_l + gl
                out_d = -state.rng_dist[..., None] * w2 * r

        # priors
        if st.NL:
            out_l = out_l + state.prior_diag.reshape(lead + (st.NL, d)) * vl

        return ChainArrowBackend._to_x(state, out_c, out_l, out_d)

    @staticmethod
    def G(problem: ConicProblem, state: CAState, x):
        return G_apply(problem, x)

    @staticmethod
    def GT(problem: ConicProblem, state: CAState, z):
        st = state.structure
        if st.relaxation == SOCP_RELAXATION:
            out_d = -z[..., 0:1]
            ga, gb = -z[..., 1:], z[..., 1:]
        else:
            out_d = -z[..., 1:]
            ga = z.new_zeros(z.shape[:-2] + (st.NR, st.d))
            gb = ga
        gc, gl = ChainArrowBackend._range_endpoint_adjoint(state, ga, gb)
        return ChainArrowBackend._to_x(state, gc, gl, out_d)

    # ---------------- factorization ---------------- #

    @staticmethod
    def _range_elimination(state: CAState, Winv2):
        st = state.structure
        d = st.d
        prec, dist = state.rng_prec, state.rng_dist
        if st.relaxation == SOCP_RELAXATION:
            w00 = Winv2[..., 0, 0]
            wv = Winv2[..., 0, 1:]
            Mtt = Winv2[..., 1:, 1:]
            kdd = 2.0 * prec + w00
            Hhat = Mtt - wv[..., :, None] * wv[..., None, :] / kdd[..., None, None]
            return kdd, wv, Hhat
        eye = torch.eye(d, dtype=Winv2.dtype, device=Winv2.device)
        Kdd = 2.0 * (prec * dist ** 2)[..., None, None] * eye + Winv2[..., 1:, 1:]
        Kdd_inv = inv_small_spd(Kdd)
        c = 2.0 * prec * dist
        Hhat = 2.0 * prec[..., None, None] * eye - (c ** 2)[..., None, None] * Kdd_inv
        return Kdd_inv, Winv2.new_zeros(Winv2.shape[:-3] + (st.NR, d)), Hhat

    @staticmethod
    def _assemble(problem: ConicProblem, state: CAState, Winv2, params):
        """W-dependent KKT block assembly: returns the chain band (Dg, Ug),
        coupling Bg, arrow Sg (regularized, identity on decoupled padding),
        the distance-elimination data and the regularization delta."""
        st = state.structure
        C, T, D, d, A = st.C, st.T, st.D, st.d, st.A
        NTB = st.NTB
        tz = NTB * d
        dev = Winv2.device

        kdd, wv, Hhat = ChainArrowBackend._range_elimination(state, Winv2)
        lead = state.D0.shape[:-4]  # (B,) for stacked trials

        Dg = state.D0.reshape(lead + (C * T, D, D)).clone()
        Bg = state.B0.clone()
        Sg = state.S0.clone()
        if st.NR:
            Hp = torch.cat([Hhat, Hhat.new_zeros(lead + (1, d, d))], dim=-3)
            # chain diagonals: each slot's incident Hhat blocks, summed
            Dg[..., d * d:, d * d:] += torch.sum(Hp[..., st.chain_inc, :, :], dim=-3)
            # arrow translation-zone blocks: Hhat on both endpoint sites'
            # diagonals, -Hhat on the (a, b) and (b, a) cross blocks; the
            # pad site NTB collects chain-resident endpoints and is cut
            Sblk = Hhat.new_zeros(lead + (NTB + 1, d, NTB + 1, d))
            ii = torch.arange(d, device=dev)[None, :, None]
            jj = torch.arange(d, device=dev)[None, None, :]
            sa = st.site_a[:, None, None]
            sb = st.site_b[:, None, None]
            _scatter_add(Sblk, (sa, ii, sa, jj), Hhat, lead)
            _scatter_add(Sblk, (sb, ii, sb, jj), Hhat, lead)
            _scatter_add(Sblk, (sa, ii, sb, jj), -Hhat, lead)
            _scatter_add(Sblk, (sb, ii, sa, jj), -Hhat.transpose(-1, -2), lead)
            Sg[..., :tz, :tz] += Sblk[..., :NTB, :, :NTB, :].reshape(lead + (tz, tz))
            # chain-arrow cross terms: a chain-resident endpoint couples to
            # its partner's arrow site with -Hhat (pad site NTB is cut)
            Hg = -Hp[..., st.chain_inc, :, :]  # (C*T, Kc, d, d)
            # (chain_other's pad site is max(NTB, 1): room for it)
            Badd = Hhat.new_zeros(lead + (C * T, d, (max(NTB, 1) + 1) * d))
            p = torch.arange(C * T, device=dev)[:, None, None, None]
            cols = st.chain_other[:, :, None, None] * d + jj[:, None]
            _scatter_add(Badd, (p, ii[:, None], cols), Hg, lead)
            Bg[..., d * d:, :tz] += Badd[..., :tz].reshape(lead + (C, T, d, tz))

        Dg = Dg.reshape(lead + (C, T, D, D))

        # masks, pin fill, regularization
        cm = st.cm
        Dg = Dg * cm[..., :, None] * cm[..., None, :]
        if lead:  # one regularization a trial
            scale = torch.maximum(Dg.abs().flatten(-4).amax(-1), Sg.abs().flatten(-2).amax(-1))
        else:
            scale = torch.maximum(Dg.abs().max(), Sg.abs().max())
        delta = params.static_reg * torch.clamp(scale, min=1.0)
        iD = torch.arange(D, device=dev)
        Dg[..., iD, iD] += (delta[..., None, None, None] if lead else delta) * cm + (1.0 - cm)
        Ug = state.U0 * cm[:, :-1, :, None] * cm[:, 1:, None, :]
        Bg = Bg * cm[..., None]
        # decoupled-identity rows for padding when the arrow is a dummy
        inactive = torch.all(Sg == 0.0, dim=-2) & torch.all(Sg == 0.0, dim=-1)
        dA = delta[..., None] if lead else delta
        Sg = Sg + torch.diag_embed(torch.where(inactive, torch.ones_like(dA), dA))
        return Dg, Ug, Bg, Sg, kdd, wv, Hhat, delta

    @staticmethod
    def _factor_band(st, Dg, Ug, Bg, Sg, delta, params):
        """Chain band factorization (the f64 band kernels, or cyclic
        reduction for f32), the arrow panel Z = T^{-1} B, and the dense
        arrow Schur complement with its Cholesky (escalated regularization
        on breakdown), all in the problem's dtype. On a sharded structure
        the rank factors its own chains, and the Schur complement's sum
        over the chains is completed across the group."""
        C, T, D, A = st.C, st.T, st.D, st.A
        dev, dt = Dg.device, Dg.dtype
        lead = Dg.shape[:-4]  # (B,) for stacked trials
        if st.shard is not None:  # this rank's chains
            part = st.shard.chains(C)
            Dg, Ug, Bg = (t[..., part, :, :, :] for t in (Dg, Ug, Bg))
            C = Dg.shape[-4]
        Tp = pad_length(T)
        Dp = torch.eye(D, dtype=dt, device=dev).expand(lead + (C, Tp, D, D)).clone()
        Dp[..., :T, :, :] = Dg
        Up = torch.zeros(lead + (C, Tp, D, D), dtype=dt, device=dev)
        if T > 1:
            Up[..., : T - 1, :, :] = Ug
        Bp = torch.zeros(lead + (C, Tp, D, A), dtype=dt, device=dev)
        Bp[..., :T, :, :] = Bg
        factor, solve = (pcr_factor, pcr_solve) if dt == torch.float32 else (band_factor,
                                                                             band_solve)
        # the trials fold into the chain axis: (B*C, Tp, D, .), one launch
        # of each band (or block) kernel for the batch
        bf = factor(Dp.reshape(-1, Tp, D, D), Up.reshape(-1, Tp, D, D))
        Z = solve(bf, Bp.reshape(-1, Tp, D, A)).reshape(Bp.shape)
        Kc = C * Tp * D
        BZ = Bp.reshape(lead + (Kc, A)).transpose(-1, -2) @ Z.reshape(lead + (Kc, A))
        if st.shard is not None:
            all_reduce(BZ, st.shard.group)
        Sg = Sg - BZ
        if lead:
            eye = torch.eye(A, dtype=dt, device=dev)
            esc = params.reg_escalation * delta
            return bf, Bp, Z, lane_cholesky(Sg, Sg + esc[..., None, None] * eye)
        LS = _cholesky_escalated(Sg, params.reg_escalation * delta)
        return bf, Bp, Z, LS

    @staticmethod
    def factor(problem: ConicProblem, state: CAState, Winv2, params) -> CAFactors:
        st = state.structure
        Dg, Ug, Bg, Sg, kdd, wv, Hhat, delta = ChainArrowBackend._assemble(
            problem, state, Winv2, params
        )
        bf, Bp, Z, LS = ChainArrowBackend._factor_band(st, Dg, Ug, Bg, Sg, delta, params)
        return CAFactors(band=bf, B=Bp, Z=Z, LS=LS, kdd=kdd, wv=wv, Hhat=Hhat,
                         Winv2=Winv2)

    # ---------------- solve ---------------- #

    @staticmethod
    def solve(problem: ConicProblem, state: CAState, factors: CAFactors, rhs, params):
        """Solve K dx = rhs through the structured factorization, with
        optional inner iterative-refinement passes against the true
        K = P + G'W^{-2}G (params.kkt_refine_steps)."""
        dx = ChainArrowBackend._solve_once(problem, state, factors, rhs)
        for _ in range(params.kkt_refine_steps):
            Gv = G_apply(problem, dx)
            Kdx = ChainArrowBackend.P_matvec(state, dx) + ChainArrowBackend.GT(
                problem, state, torch.einsum("...mij,...mj->...mi", factors.Winv2, Gv)
            )
            resid = state.mask * (rhs - Kdx)
            dx = dx + ChainArrowBackend._solve_once(problem, state, factors, resid)
        return dx

    @staticmethod
    def _band_solve(st, factors: CAFactors, rc, ra):
        """Solve the chain+arrow band system
            [T B; B' S][x; u] = [rc; ra]  =>
            w = T^{-1} rc,  u = Stilde^{-1}(ra - B' w),  x = w - T^{-1}B u.
        On a sharded structure the rank solves its own chains; B'w and the
        chain solution are completed across the group (the solution as the
        sum of zero-filled shards: exact, each entry has one non-zero
        addend)."""
        C, T, D, A = st.C, st.T, st.D, st.A
        lead = rc.shape[:-3]  # (B,) for stacked trials
        if st.shard is not None:  # this rank's chains
            part = st.shard.chains(C)
            rc = rc[..., part, :, :]
            C = rc.shape[-3]
        Tp = factors.B.shape[-3]
        rp = torch.zeros(lead + (C, Tp, D, 1), dtype=rc.dtype, device=rc.device)
        rp[..., :T, :, 0] = rc
        solve = pcr_solve if isinstance(factors.band, PCRFactors) else band_solve
        # (the trials folded into the chain axis, as the factor has them)
        w = solve(factors.band, rp.reshape(-1, Tp, D, 1))[..., 0].reshape(lead + (C, Tp, D))
        Kc = C * Tp * D
        Bt = factors.B.reshape(lead + (Kc, A)).transpose(-1, -2)
        Zf = factors.Z.reshape(lead + (Kc, A))
        if lead:
            Bw = (Bt @ w.reshape(lead + (Kc, 1)))[..., 0]
        else:
            Bw = Bt @ w.reshape(Kc)
        if st.shard is not None:
            all_reduce(Bw, st.shard.group)
        ra_schur = ra - Bw
        y = torch.linalg.solve_triangular(factors.LS, ra_schur[..., None], upper=False)
        u = torch.linalg.solve_triangular(factors.LS.transpose(-1, -2), y, upper=True)[..., 0]
        Zu = (Zf @ u[..., None])[..., 0] if lead else Zf @ u
        dxc = (w - Zu.reshape(lead + (C, Tp, D)))[..., :T, :]
        if st.shard is not None:
            full = dxc.new_zeros(lead + (st.C, T, D))
            full[..., part, :, :] = dxc
            dxc = all_reduce(full, st.shard.group)
        return dxc, u

    @staticmethod
    def _solve_once(problem: ConicProblem, state: CAState, factors: CAFactors, rhs):
        st = state.structure
        d = st.d
        lead = rhs.shape[:-1]  # (B,) for stacked trials
        vc, vl, rd = ChainArrowBackend._gather(state, rhs)

        # eliminate distance variables from the rhs
        if st.NR:
            if st.relaxation == SOCP_RELAXATION:
                tvec = factors.wv * (rd / factors.kdd[..., None])
                ga, gb = -tvec, tvec
            else:
                tvec = torch.einsum("...mij,...mj->...mi", factors.kdd, rd)
                c = (2.0 * state.rng_prec * state.rng_dist)[..., None]
                ga, gb = c * tvec, -c * tvec
            dc, dl = ChainArrowBackend._range_endpoint_adjoint(state, ga, gb)
            vc = vc + dc
            vl = vl + dl

        # split into chain rhs and arrow rhs (one gather per arrow column)
        rc = vc * st.cm
        combined = torch.cat([vc.reshape(lead + (-1,)), vl.reshape(lead + (-1,)),
                              vc.new_zeros(lead + (1,))], dim=-1)
        ra = combined[..., st.arrow_src]

        dxc, u = ChainArrowBackend._band_solve(st, factors, rc, ra)

        # recompose pose slots: chain part + arrow-resident entries
        u_pad = torch.cat([u, u.new_zeros(lead + (1,))], dim=-1)
        dx_full = dxc * st.cm + u_pad[..., st.arrow_col] * st.av
        dxl = u[..., : st.NL * d].reshape(lead + (st.NL, d))

        # back-substitute distances
        if st.NR:
            dx_for_ends = ChainArrowBackend._to_x(state, dx_full, dxl, torch.zeros_like(rd))
            ta, tb = ChainArrowBackend._range_endpoint_values(state, dx_for_ends)
            du = ta - tb
            if st.relaxation == SOCP_RELAXATION:
                dd = ((rd[..., 0] - torch.einsum("...mi,...mi->...m", factors.wv, du))
                      / factors.kdd)[..., None]
            else:
                c = (2.0 * state.rng_prec * state.rng_dist)[..., None]
                dd = torch.einsum("...mij,...mj->...mi", factors.kdd, rd + c * du)
        else:
            dd = torch.zeros_like(rd)

        return ChainArrowBackend._to_x(state, dx_full, dxl, dd)


def checked_cholesky(S: torch.Tensor) -> Optional[torch.Tensor]:
    """The Cholesky factor of S, or None on breakdown: ``cholesky_ex``
    reports it through ``info`` and may return a partial factor that is
    finite (on the card), so a factor counts only with info == 0 and every
    entry finite. One synchronisation."""
    L, info = torch.linalg.cholesky_ex(S)
    return L if bool(((info == 0) & torch.isfinite(L).all()).item()) else None


def lane_cholesky(first: torch.Tensor, retry: torch.Tensor) -> torch.Tensor:
    """Cholesky factors of a batch (B, n, n), lane by lane with no host
    read: a lane's factor of ``first``, or where that breaks down (as
    :func:`checked_cholesky` tests it: info != 0 or a non-finite entry) its
    factor of ``retry``, or NaN where both do. Both batches are factored
    and the lanes selected on the device, as the JAX package's retry
    (``lax.cond``) runs under ``vmap``."""
    L1, info1 = torch.linalg.cholesky_ex(first)
    L2, info2 = torch.linalg.cholesky_ex(retry)
    ok1 = (info1 == 0) & torch.isfinite(L1).flatten(-2).all(-1)
    ok2 = (info2 == 0) & torch.isfinite(L2).flatten(-2).all(-1)
    L2 = torch.where(ok2[..., None, None], L2, float("nan"))
    return torch.where(ok1[..., None, None], L1, L2)


def _cholesky_escalated(S: torch.Tensor, esc: torch.Tensor) -> torch.Tensor:
    """Cholesky of S; on breakdown retry on S + esc*I. A second breakdown
    yields a NaN factor, so the step turns non-finite and the solver
    reports a numerical error, as the JAX backend's NaN-returning cholesky
    does."""
    L = checked_cholesky(S)
    if L is None:
        eye = torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
        L = checked_cholesky(S + esc * eye)
        if L is None:
            L = torch.full_like(S, float("nan"))
    return L
