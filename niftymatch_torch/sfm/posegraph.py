"""Pose-graph optimisation: batched Gauss-Newton on SE(3) and Sim(3)
(``sfm/posegraph.py`` of the JAX package).

Fixed-shape edge table (i, j, measurement, weight, valid); edge Jacobians
by forward-mode autodiff (``torch.func.vmap(torch.func.jacfwd(...))`` over
edges, as the JAX file's ``vmap(jacfwd(...))``: reverse mode would turn
the inf of ``so3_log``'s discarded branches into NaN); dense damped normal
equations (6N x 6N or 7N x 7N) assembled with ``index_put_(...,
accumulate=True)`` on the (N, N, k, k) block tensor and solved with
``torch.linalg.solve_ex``, or for large Sim(3) graphs a matrix-free block
CG.  Every loop is a Python loop over a fixed count whose accept/reject,
cost and damping stay on the device.  On CUDA the accumulating adds use
atomics, so two runs may differ in the last bits.  Gauge fixed by a node
mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..utils.precision import f32, resolve_device, state_to
from .se3 import se3_compose, se3_exp, se3_inverse, se3_log
from .sim3 import sim3_compose, sim3_error, sim3_inverse, sim3_retract


class PoseGraph(NamedTuple):
    """poses: (N, 3, 4) world->cam.  Edges: measurement Z_e ~ T_i T_j^-1
    (relative pose of node j expressed in node i), with scalar information
    weight; ``edge_valid`` masks unused capacity; ``node_fixed`` pins gauge."""

    poses: torch.Tensor        # (N, 3, 4)
    edge_i: torch.Tensor       # (E,) int32
    edge_j: torch.Tensor       # (E,) int32
    edge_T: torch.Tensor       # (E, 3, 4) measured T_i T_j^-1
    edge_weight: torch.Tensor  # (E,) float32
    edge_valid: torch.Tensor   # (E,) bool
    node_fixed: torch.Tensor   # (N,) bool


class Sim3Graph(NamedTuple):
    """Nodes: sim3 world->cam (scale (N,), T (N, 3, 4)).  Edge e measures
    Z_e = S_i o S_j^-1 with relative scale ``edge_s`` (1.0 for odometry;
    the map-alignment scale for loop edges)."""

    scale: torch.Tensor        # (N,)
    poses: torch.Tensor        # (N, 3, 4)
    edge_i: torch.Tensor       # (E,) int32
    edge_j: torch.Tensor       # (E,) int32
    edge_s: torch.Tensor       # (E,) measured relative scale
    edge_T: torch.Tensor       # (E, 3, 4) measured relative pose
    edge_weight: torch.Tensor  # (E,)
    edge_valid: torch.Tensor   # (E,) bool
    node_fixed: torch.Tensor   # (N,) bool


class PGOStats(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    costs: torch.Tensor


@f32
def edge_residual(Ti, Tj, Z) -> torch.Tensor:
    """(6,) tangent residual log(Z^-1 T_i T_j^-1); takes leading batch axes."""
    return se3_log(se3_compose(se3_inverse(Z), se3_compose(Ti, se3_inverse(Tj))))


def _edge_weights(graph) -> torch.Tensor:
    return graph.edge_weight * graph.edge_valid.to(torch.float32)


@f32
def graph_cost(graph: PoseGraph) -> torch.Tensor:
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    r = edge_residual(graph.poses[ei], graph.poses[ej], graph.edge_T)
    return (_edge_weights(graph) * (r * r).sum(-1)).sum()


def _se3_r_of(xi_i, xi_j, Ti, Tj, Z):
    return edge_residual(se3_compose(se3_exp(xi_i), Ti),
                         se3_compose(se3_exp(xi_j), Tj), Z)


def _edge_linearization(graph: PoseGraph):
    """Residuals (E, 6) and Jacobians (E, 6, 6) wrt left tangents of i, j."""
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    Ti, Tj, Z = graph.poses[ei], graph.poses[ej], graph.edge_T
    zero = torch.zeros((6,), dtype=graph.poses.dtype, device=graph.poses.device)
    r = edge_residual(Ti, Tj, Z)
    Ji, Jj = vmap(lambda a, b, c: jacfwd(_se3_r_of, argnums=(0, 1))(zero, zero, a, b, c)
                  )(Ti, Tj, Z)
    return r, Ji, Jj


def _edge_blocks(Ji, Jj, r, w):
    """Per-edge normal-equation blocks Hii, Hjj, Hij (E, k, k) and
    gradients bi, bj (E, k) with edge weights w (E,)."""
    w3 = w[:, None, None]
    Hii = torch.einsum("eki,ekj->eij", Ji, Ji) * w3
    Hjj = torch.einsum("eki,ekj->eij", Jj, Jj) * w3
    Hij = torch.einsum("eki,ekj->eij", Ji, Jj) * w3
    bi = -torch.einsum("eki,ek->ei", Ji, r) * w[:, None]
    bj = -torch.einsum("eki,ek->ei", Jj, r) * w[:, None]
    return Hii, Hjj, Hij, bi, bj


def _dense_solve(ei, ej, blocks, node_fixed, lam, N: int, k: int):
    """Assemble the dense damped kN x kN normal equations from per-edge
    blocks, pin fixed nodes to identity rows, solve: (N, k) step (zero on
    fixed nodes) and the (N, 1) free mask."""
    Hii, Hjj, Hij, bi, bj = blocks
    dtype, dev = Hii.dtype, Hii.device
    H = torch.zeros((N, N, k, k), dtype=dtype, device=dev)
    H.index_put_((ei, ei), Hii, accumulate=True)
    H.index_put_((ej, ej), Hjj, accumulate=True)
    H.index_put_((ei, ej), Hij, accumulate=True)
    H.index_put_((ej, ei), Hij.transpose(-1, -2), accumulate=True)
    b = torch.zeros((N, k), dtype=dtype, device=dev)
    b.index_add_(0, ei, bi).index_add_(0, ej, bj)

    Hd = H.permute(0, 2, 1, 3).reshape(k * N, k * N)
    Hd = Hd + (lam + 1e-8) * torch.eye(k * N, dtype=dtype, device=dev)
    free = (~node_fixed).to(dtype)
    fm = free.repeat_interleave(k)
    Hd = Hd * fm[:, None] * fm[None, :] + torch.diag(1.0 - fm)
    rhs = b.reshape(k * N) * fm
    dxi = torch.linalg.solve_ex(Hd, rhs).result.reshape(N, k)
    return dxi * free[:, None]


def _lm(init_cost, state, solve, cost_of, iterations: int, damping: float):
    """Damped Gauss-Newton with branchless accept/reject: ``solve(state,
    lam)`` proposes a candidate state (a tuple of tensors), kept iff
    ``cost_of`` it is lower; damping x0.5 / x4 in [1e-10, 1e6]."""
    cost = init_cost
    lam = torch.full((), damping, dtype=torch.float32, device=init_cost.device)
    costs = []
    for _ in range(iterations):
        cand = solve(state, lam)
        new_cost = cost_of(cand)
        accept = new_cost < cost
        state = tuple(torch.where(accept, c, s) for c, s in zip(cand, state))
        cost = torch.where(accept, new_cost, cost)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e6)
        costs.append(cost)
    return state, PGOStats(initial_cost=init_cost, final_cost=cost,
                           costs=torch.stack(costs))


@f32
def optimize_pose_graph(graph: PoseGraph, iterations: int = 10, damping: float = 1e-6,
                        device=None) -> tuple[PoseGraph, PGOStats]:
    """Damped Gauss-Newton with branchless accept/reject (LM-style), on
    ``device`` (CUDA by default), to which the graph is moved."""
    graph = state_to(graph, resolve_device(device))
    N = graph.poses.shape[0]
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    w = _edge_weights(graph)

    def solve(state, lam):
        (poses,) = state
        r, Ji, Jj = _edge_linearization(graph._replace(poses=poses))
        dxi = _dense_solve(ei, ej, _edge_blocks(Ji, Jj, r, w), graph.node_fixed,
                           lam, N, 6)
        return (se3_compose(se3_exp(dxi), poses),)

    (poses,), stats = _lm(graph_cost(graph), (graph.poses,), solve,
                          lambda s: graph_cost(graph._replace(poses=s[0])),
                          iterations, damping)
    return graph._replace(poses=poses), stats


# ---------------------------------------------------------------------------
# Sim(3) pose graph: scale-drift-aware monocular loop closure (Strasdat et
# al. RSS 2010; the ORB-SLAM loop-closing formulation).  The loop-closure
# constraint carries a relative SCALE as well as a relative pose, and only
# a 7-DoF state per node lets the optimiser distribute it around the loop.
# ---------------------------------------------------------------------------


@f32
def sim3_edge_residual(si, Ti, sj, Tj, zs, zT) -> torch.Tensor:
    """(7,) residual err(Z^-1 S_i S_j^-1) of one edge (vmap for many)."""
    s_ij, T_ij = sim3_compose(si, Ti, *sim3_inverse(sj, Tj))
    zs_inv, zT_inv = sim3_inverse(zs, zT)
    return sim3_error(*sim3_compose(zs_inv, zT_inv, s_ij, T_ij))


def _sim3_args(graph: Sim3Graph, scale, poses):
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    return scale[ei], poses[ei], scale[ej], poses[ej], graph.edge_s, graph.edge_T


@f32
def sim3_graph_cost(graph: Sim3Graph, huber_delta: float | None = None) -> torch.Tensor:
    """Weighted residual cost; with ``huber_delta`` each edge's squared
    residual norm is Huber-truncated (rho^2 below delta, linear above), so
    a single wrong loop edge contributes a bounded pull."""
    r = vmap(sim3_edge_residual)(*_sim3_args(graph, graph.scale, graph.poses))
    rho2 = (r * r).sum(-1)
    if huber_delta is not None:
        rho = torch.sqrt(torch.clamp(rho2, min=1e-24))
        d = float(huber_delta)
        rho2 = torch.where(rho <= d, rho2, 2.0 * d * rho - d * d)
    return (_edge_weights(graph) * rho2).sum()


def _huber_irls_weights(r: torch.Tensor, huber_delta) -> torch.Tensor:
    """(E,) IRLS weights min(1, delta / ||r||) for the Huber kernel."""
    rho = torch.sqrt(torch.clamp((r * r).sum(-1), min=1e-24))
    return torch.clamp(float(huber_delta) / rho, max=1.0)


def _sim3_r_of(xi_i, xi_j, si, Ti, sj, Tj, zs, zT):
    return sim3_edge_residual(*sim3_retract(xi_i, si, Ti),
                              *sim3_retract(xi_j, sj, Tj), zs, zT)


def _sim3_linearization(graph: Sim3Graph, scale, poses, huber_delta):
    """Residuals (E, 7), Jacobians (E, 7, 7) wrt the left tangents of i
    and j, and the (Huber-reweighted) edge weights (E,)."""
    args = _sim3_args(graph, scale, poses)
    zero = torch.zeros((7,), dtype=poses.dtype, device=poses.device)
    r = vmap(lambda *a: _sim3_r_of(zero, zero, *a))(*args)
    Ji, Jj = vmap(lambda *a: jacfwd(_sim3_r_of, argnums=(0, 1))(zero, zero, *a))(*args)
    w = _edge_weights(graph)
    if huber_delta is not None:
        w = w * _huber_irls_weights(r, huber_delta)
    return r, Ji, Jj, w


def _sim3_lm(graph: Sim3Graph, iterations, damping, huber_delta, step):
    """The LM loop of both Sim(3) solvers around ``step(scale, poses, lam)
    -> dxi (N, 7)``."""
    def solve(state, lam):
        scale, poses = state
        return vmap(sim3_retract)(step(scale, poses, lam), scale, poses)

    def cost_of(state):
        return sim3_graph_cost(graph._replace(scale=state[0], poses=state[1]),
                               huber_delta)

    (scale, poses), stats = _lm(sim3_graph_cost(graph, huber_delta),
                                (graph.scale, graph.poses), solve, cost_of,
                                iterations, damping)
    return graph._replace(scale=scale, poses=poses), stats


@f32
def optimize_pose_graph_sim3(graph: Sim3Graph, iterations: int = 12,
                             damping: float = 1e-6, huber_delta: float | None = None,
                             device=None) -> tuple[Sim3Graph, PGOStats]:
    """Damped Gauss-Newton over 7-DoF nodes, branchless accept/reject.

    Same structure as :func:`optimize_pose_graph` with the node state
    extended by log-scale.  ``huber_delta`` enables IRLS Huber robustness:
    each edge's weight is scaled by min(1, delta/||r||) at every outer
    iteration and the accept/reject cost uses the matching robust kernel."""
    graph = state_to(graph, resolve_device(device))
    N = graph.poses.shape[0]
    ei, ej = graph.edge_i.long(), graph.edge_j.long()

    def step(scale, poses, lam):
        r, Ji, Jj, w = _sim3_linearization(graph, scale, poses, huber_delta)
        return _dense_solve(ei, ej, _edge_blocks(Ji, Jj, r, w), graph.node_fixed,
                            lam, N, 7)

    return _sim3_lm(graph, iterations, damping, huber_delta, step)


@f32
def optimize_pose_graph_sim3_cg(graph: Sim3Graph, iterations: int = 12,
                                damping: float = 1e-6, cg_iterations: int = 64,
                                huber_delta: float | None = None,
                                device=None) -> tuple[Sim3Graph, PGOStats]:
    """Sim(3) pose-graph Gauss-Newton with a matrix-free block-sparse CG
    inner solve, for graphs too large for the dense (N, N, 7, 7) H.

    ``H @ x`` is applied edge-wise from the per-edge blocks (Hii, Hjj,
    Hij) by gathers and ``index_add_``: O(E) memory, O(49 E) operations a
    CG step.  A block-Jacobi preconditioner (per-node 7x7 diagonal block,
    inverted once per outer iteration) keeps CG short on the near-chain
    graphs loop closure produces.  The outer loop is the dense path's."""
    graph = state_to(graph, resolve_device(device))
    N = graph.poses.shape[0]
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    dtype, dev = graph.poses.dtype, graph.poses.device
    free = (~graph.node_fixed).to(dtype)[:, None]                # (N, 1)
    eye7 = torch.eye(7, dtype=dtype, device=dev)

    def scatter(vi, vj):
        out = torch.zeros((N,) + vi.shape[1:], dtype=dtype, device=dev)
        return out.index_add_(0, ei, vi).index_add_(0, ej, vj)

    def step(scale, poses, lam):
        r, Ji, Jj, w = _sim3_linearization(graph, scale, poses, huber_delta)
        Hii, Hjj, Hij, bi, bj = _edge_blocks(Ji, Jj, r, w)
        b = scatter(bi, bj) * free

        def Hx(x):
            # Gauge-fixed damped product: rows/cols of fixed nodes are
            # identity (the dense path's masking).
            xm = x * free
            xi, xj = xm[ei], xm[ej]
            yi = torch.einsum("eab,eb->ea", Hii, xi) + torch.einsum("eab,eb->ea", Hij, xj)
            yj = torch.einsum("eab,eb->ea", Hjj, xj) + torch.einsum("eba,eb->ea", Hij, xi)
            return (scatter(yi, yj) + (lam + 1e-8) * xm) * free + x * (1.0 - free)

        # Block-Jacobi preconditioner from the per-node diagonal blocks;
        # fixed nodes get identity blocks (their equations are x = 0).
        D = scatter(Hii, Hjj) + (lam + 1e-8) * eye7
        D = D * free[..., None] + eye7 * (1.0 - free[..., None])
        Dinv = torch.linalg.inv_ex(D).inverse

        def precond(v):
            return torch.einsum("nab,nb->na", Dinv, v)

        # Preconditioned CG on H dx = b.
        x = torch.zeros_like(b)
        rr = b
        z = precond(rr)
        p = z
        rz = (rr * z).sum()
        for _ in range(cg_iterations):
            Ap = Hx(p)
            denom = (p * Ap).sum()
            alpha = torch.where(denom > 0, rz / torch.where(denom > 0, denom, 1.0), 0.0)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = precond(rr)
            rz_new = (rr * z).sum()
            beta = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, 1.0), 0.0)
            p = z + beta * p
            rz = rz_new
        return x * free

    return _sim3_lm(graph, iterations, damping, huber_delta, step)
