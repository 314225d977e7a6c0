"""Distributed pose-graph optimization: edges partitioned over the mesh
(port of ``parallel/dist_pg.py``).

The pose graph's EDGE set is partitioned across the ``model`` mesh axis
(each rank owns E/M edges, cross-partition edges included: Gauss-Newton
assembly is a pure sum over edges). Per iteration each rank assembles its
partial normal equations; ONE ``all_reduce`` sums (H, b, cost); the
gauge-fixed damped solve and the pose update run replicated (N poses are
few; the O((6N)^2) H matrix is the communication payload, the O(E)
residual and Jacobian work is what scales out).

This mirrors ``parallel/dist_ba.py``'s landmark-sharded Schur reduction
one level up the back-end stack; ``python -m ethzasl_brisk_tpu_torch.parallel
worker`` runs both across processes.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ethzasl_brisk_tpu_torch.ba.pose_graph import (
    PoseGraph,
    assemble_normal_equations,
    pose_graph_plans,
    solve_and_update,
)
from ethzasl_brisk_tpu_torch.parallel.frames import mesh_axis, mesh_device


def partition_edges(graph: PoseGraph, n_shards: int) -> PoseGraph:
    """Pad the edge set to a multiple of n_shards (zero-weight padding
    edges reference node 0 and contribute nothing to the assembly)."""
    e = graph.edge_i.shape[0]
    pad = (-e) % n_shards
    if pad == 0:
        return graph
    dev = graph.edge_i.device
    zeros_e = torch.zeros(pad, dtype=graph.edge_i.dtype, device=dev)
    eye = torch.eye(3, dtype=graph.rel_r.dtype, device=dev).expand(pad, 3, 3)
    return dataclasses.replace(
        graph,
        edge_i=torch.cat([graph.edge_i, zeros_e]),
        edge_j=torch.cat([graph.edge_j, zeros_e]),
        rel_r=torch.cat([graph.rel_r, eye]),
        rel_t=torch.cat([graph.rel_t, graph.rel_t.new_zeros((pad, 3))]),
        weight=torch.cat([graph.weight, graph.weight.new_zeros((pad,))]),  # zero weight
    )


def optimize_pose_graph_sharded(mesh, graph: PoseGraph, iterations: int = 10,
                                damping: float = 1e-6):
    """Edge-sharded GN over the ``model`` axis. Returns (graph, costs),
    the same on every rank.

    Every rank passes the whole graph, its edges padded to a multiple of
    the axis size (``partition_edges``); rank m takes edge block m. H, b
    and the cost are summed across ranks, so expect float-level agreement
    with the single-device path (exact with one rank).
    """
    group, n_shards, coord = mesh_axis(mesh, "model")
    dev = mesh_device(mesh)
    n = graph.r.shape[0]
    e = graph.edge_i.shape[0]
    if e % n_shards:
        raise ValueError(f"{e} edges must divide over {n_shards} ranks (partition_edges)")
    rows = slice(coord * (e // n_shards), (coord + 1) * (e // n_shards))
    g = PoseGraph(
        r=graph.r.to(dev), t=graph.t.to(dev),
        edge_i=graph.edge_i[rows].to(dev), edge_j=graph.edge_j[rows].to(dev),
        rel_r=graph.rel_r[rows].to(dev), rel_t=graph.rel_t[rows].to(dev),
        weight=graph.weight[rows].to(dev),
    )
    n_h = 36 * n * n
    plans = pose_graph_plans(g, n)   # once: the edges stay
    costs = []
    for _ in range(iterations):
        h, b, cost = assemble_normal_equations(g, n, plans)
        flat = torch.cat([h.reshape(-1), b.reshape(-1), cost.reshape(1)])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        h = flat[:n_h].reshape(n, 6, n, 6)
        b = flat[n_h:n_h + 6 * n].reshape(n, 6)
        g = solve_and_update(g, h, b, damping)
        costs.append(flat[-1])
    costs = torch.stack(costs) if costs else torch.zeros((0,), dtype=g.r.dtype, device=dev)
    return dataclasses.replace(graph, r=g.r, t=g.t), costs
