"""Pose-graph optimization over SE(3) relative constraints (port of
``ba/pose_graph.py``).

Nodes are camera-from-world poses; edges are measured relative transforms
T_ij ~ T_i o T_j^-1 with residual log(T_ij^-1 T_i T_j^-1) in se(3).
Batched Gauss-Newton: all edge residuals and Jacobians at once, dense
(6N x 6N) normal equations, a fixed iteration count, node 0 gauge-fixed.

Jacobians use the small-increment approximation J_i = Ad(T_m^-1),
J_j = -Ad(T_m^-1 T_i T_j^-1); a fixed damping keeps early iterations
stable. The blocks are segment sums (``ba/segment.py``) on the flat (i, j)
index of an (N, N, 6, 6) tensor, so a node on two edges keeps both of its
(i, i) blocks; the CSRs are built once an optimization
(``pose_graph_plans``), and each segment adds in edge order, as four
``index_add_`` calls after one another would on the CPU, on either device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ethzasl_brisk_tpu_torch.ba.se3 import hat, se3_compose, se3_exp, se3_inverse, se3_log, solve
from ethzasl_brisk_tpu_torch.ba.segment import SegmentPlan, segment_plan, segment_sums
from ethzasl_brisk_tpu_torch.core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class PoseGraph:
    r: torch.Tensor        # (N, 3, 3)
    t: torch.Tensor        # (N, 3)
    edge_i: torch.Tensor   # (E,) int64
    edge_j: torch.Tensor   # (E,) int64
    rel_r: torch.Tensor    # (E, 3, 3) measured T_ij = T_i o T_j^-1
    rel_t: torch.Tensor    # (E, 3)
    weight: torch.Tensor   # (E,)

    @staticmethod
    def from_numpy(arrays, device: str | torch.device = "cuda") -> "PoseGraph":
        """A graph from host arrays keyed by field name (``np.asarray`` of
        each field of the JAX ``PoseGraph``); edge indices become int64."""
        dev = resolve_device(device)
        out = {}
        for f in dataclasses.fields(PoseGraph):
            a = np.asarray(arrays[f.name])
            if f.name in ("edge_i", "edge_j"):
                a = a.astype(np.int64)
            out[f.name] = torch.from_numpy(np.array(a)).to(dev)
        return PoseGraph(**out)


def _adjoint(r, t):
    """SE(3) adjoint (..., 6, 6) for twist order (omega, v)."""
    z = torch.zeros_like(r)
    top = torch.cat([r, z], -1)
    bottom = torch.cat([hat(t) @ r, r], -1)
    return torch.cat([top, bottom], -2)


def _edge_residuals(g: PoseGraph):
    ri, ti = g.r[g.edge_i], g.t[g.edge_i]
    rj, tj = g.r[g.edge_j], g.t[g.edge_j]
    rj_inv, tj_inv = se3_inverse(rj, tj)
    r_est, t_est = se3_compose(ri, ti, rj_inv, tj_inv)
    rm_inv, tm_inv = se3_inverse(g.rel_r, g.rel_t)
    r_err, t_err = se3_compose(rm_inv, tm_inv, r_est, t_est)
    return se3_log(r_err, t_err)  # (E, 6)


def pose_graph_plans(g: PoseGraph, n: int) -> tuple[SegmentPlan, SegmentPlan]:
    """The CSRs of H's flat (i, j) index over the four block pairs, one
    pair's edges after the other, and of b's (i, then j) index."""
    ei, ej = g.edge_i, g.edge_j
    h_idx = torch.cat([ei * n + ei, ei * n + ej, ej * n + ei, ej * n + ej])
    return segment_plan(h_idx, n * n), segment_plan(torch.cat([ei, ej]), n)


def assemble_normal_equations(g: PoseGraph, n: int,
                              plans: tuple[SegmentPlan, SegmentPlan] | None = None):
    """Edge-parallel GN assembly: returns (H (N,6,N,6), b (N,6), cost).

    A pure sum over edges; zero-weight edges contribute nothing (padding).
    ``plans`` (``pose_graph_plans``) is built here unless given.
    """
    h_plan, b_plan = plans or pose_graph_plans(g, n)
    res = _edge_residuals(g)  # (E, 6)
    w = g.weight

    rm_inv, tm_inv = se3_inverse(g.rel_r, g.rel_t)
    ad_i = _adjoint(rm_inv, tm_inv)
    ri, ti = g.r[g.edge_i], g.t[g.edge_i]
    rj, tj = g.r[g.edge_j], g.t[g.edge_j]
    rj_inv, tj_inv = se3_inverse(rj, tj)
    r_est, t_est = se3_compose(ri, ti, rj_inv, tj_inv)
    r_c, t_c = se3_compose(rm_inv, tm_inv, r_est, t_est)
    ad_j = -_adjoint(r_c, t_c)

    wb = w[:, None, None]
    h_obs = [torch.einsum("eai,eab->eib", ja * wb, jb)
             for ja, jb in ((ad_i, ad_i), (ad_i, ad_j), (ad_j, ad_i), (ad_j, ad_j))]
    h, b = segment_sums([(torch.cat(h_obs), h_plan),
                         (torch.cat([torch.einsum("eai,ea->ei", ad_i * wb, res),
                                     torch.einsum("eai,ea->ei", ad_j * wb, res)]), b_plan)])
    cost = torch.sum(res * res * w[:, None])
    return h.reshape(n, n, 6, 6).permute(0, 2, 1, 3), b, cost


def solve_and_update(g: PoseGraph, h, b, damping):
    """Gauge-fixed damped solve + left-increment pose update."""
    n = g.r.shape[0]
    dt, dev = h.dtype, h.device
    hm = h.reshape(6 * n, 6 * n) + damping * torch.eye(6 * n, dtype=dt, device=dev)
    bv = b.reshape(6 * n)
    fix = torch.arange(6 * n, device=dev) < 6
    zero = torch.zeros((), dtype=dt, device=dev)
    hm = torch.where(fix[:, None] | fix[None, :], zero, hm)
    hm = hm + torch.diag(fix.to(dt))
    bv = torch.where(fix, zero, bv)

    delta = -solve(hm, bv[:, None])[:, 0].reshape(n, 6)
    dr, dtr = se3_exp(delta)
    r_new = dr @ g.r
    t_new = torch.einsum("nij,nj->ni", dr, g.t) + dtr
    return dataclasses.replace(g, r=r_new, t=t_new)


def _step(g: PoseGraph, damping, plans):
    h, b, cost = assemble_normal_equations(g, g.r.shape[0], plans)
    return solve_and_update(g, h, b, damping), cost


def optimize_pose_graph(graph: PoseGraph, iterations: int = 10, damping: float = 1e-6):
    """Fixed-iteration GN. Returns (graph, costs (iterations,))."""
    plans = pose_graph_plans(graph, graph.r.shape[0])
    costs = []
    for _ in range(iterations):
        graph, cost = _step(graph, damping, plans)
        costs.append(cost)
    if not costs:
        return graph, torch.zeros((0,), dtype=graph.r.dtype, device=graph.r.device)
    return graph, torch.stack(costs)
