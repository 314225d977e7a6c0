"""Distributed windowed BA: landmark/map-block sharding over the mesh
(port of ``parallel/dist_ba.py``).

The north-star distributed-BA design (SURVEY.md section 2.5): landmarks
and their observations are partitioned across the ``model`` mesh axis (map
blocks); poses are replicated. Each rank assembles its landmarks'
contribution to the reduced (Schur) pose system; the (6K x 6K) reduced
Hessian, the rhs and the cost are summed over the axis with
``all_reduce`` (the only cross-device traffic, O(K^2), independent of the
landmark count); every rank solves the small pose system redundantly
(cheaper than a broadcast) and back-substitutes its local landmarks; the
points are gathered back whole at the end.

Observations must be pre-partitioned so a landmark's observations live on
its own rank (``partition_problem`` builds that layout on the host).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ethzasl_brisk_tpu_torch.ba.se3 import se3_exp, solve
from ethzasl_brisk_tpu_torch.ba.segment import segment_sums
from ethzasl_brisk_tpu_torch.ba.window import BaPlans, BaProblem, _residual_and_jacobians, ba_plans
from ethzasl_brisk_tpu_torch.parallel.frames import all_gather_cat, mesh_axis, mesh_device


def _local_schur(p: BaProblem, damping, plans: BaPlans):
    """One rank's contribution: reduced system pieces + local landmark
    solve terms. The math of ba.window._gauss_newton_step with one pose
    fixed and no robust weights, with the pose-space reduction returned
    for a cross-rank sum."""
    res, j_po, j_pt, w = _residual_and_jacobians(p)
    k = p.r.shape[0]
    n_lm = p.points.shape[0]
    dt, dev = res.dtype, res.device
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    wres = res * w[:, None]
    j_po_w = j_po * w[:, None, None]
    b_blocks, c_blocks, g_pose, g_pt, e_dense = segment_sums([
        (torch.einsum("oai,oab->oib", j_po_w, j_po), plans.kf),
        (torch.einsum("oai,oab->oib", j_pt * w[:, None, None], j_pt), plans.lm),
        (torch.einsum("oai,oa->oi", j_po, wres), plans.kf),
        (torch.einsum("oai,oa->oi", j_pt, wres), plans.lm),
        (torch.einsum("oai,oab->oib", j_po_w, j_pt), plans.lm_kf),
    ])
    e_dense = e_dense.reshape(n_lm, k, 6, 3)
    c_inv = torch.linalg.inv_ex(c_blocks + damping * eye3[None] + 1e-9 * eye3)[0]
    ec = torch.einsum("lkis,lst->lkit", e_dense, c_inv)
    s_red = torch.einsum("lkit,lmjt->kimj", ec, e_dense)
    b_kk = torch.zeros((k, k, 6, 6), dtype=dt, device=dev)
    ar = torch.arange(k, device=dev)
    b_kk[ar, ar] = b_blocks + damping * eye6[None]
    s_local = b_kk.permute(0, 2, 1, 3) - s_red
    rhs_local = g_pose - torch.einsum("lkit,lt->ki", ec, g_pt)
    cost_local = torch.sum(wres * res)
    return s_local, rhs_local, (c_inv, e_dense, g_pt), cost_local


def _dist_step(p: BaProblem, damping, group, plans: BaPlans):
    k = p.r.shape[0]
    s_local, rhs_local, (c_inv, e_dense, g_pt), cost_l = _local_schur(p, damping, plans)
    # The only cross-rank communication: one sum of (S, rhs, cost).
    n_s = 36 * k * k
    flat = torch.cat([s_local.reshape(-1), rhs_local.reshape(-1), cost_l.reshape(1)])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    s = flat[:n_s].reshape(6 * k, 6 * k)
    rhs = flat[n_s:n_s + 6 * k]
    cost = flat[-1]

    dt, dev = s.dtype, s.device
    fix = torch.arange(6 * k, device=dev) < 6
    zero = torch.zeros((), dtype=dt, device=dev)
    s = torch.where(fix[:, None] | fix[None, :], zero, s)
    s = s + torch.diag(fix.to(dt))
    rhs = torch.where(fix, zero, rhs)
    delta_pose = -solve(s, rhs[:, None])[:, 0].reshape(k, 6)

    et_dx = torch.einsum("lkis,ki->ls", e_dense, delta_pose)
    delta_pt = -torch.einsum("lst,lt->ls", c_inv, g_pt + et_dx)

    dr, dtr = se3_exp(delta_pose)
    r_new = dr @ p.r
    t_new = torch.einsum("kij,kj->ki", dr, p.t) + dtr
    return dataclasses.replace(p, r=r_new, t=t_new, points=p.points + delta_pt), cost


def solve_window_ba_sharded(mesh, problem: BaProblem, iterations: int = 10,
                            damping: float = 1e-4, axis: str = "model"):
    """Landmark-sharded BA over ``axis``. Every rank passes the whole
    problem laid out by ``partition_problem`` (global ``lm_idx``); rank m
    takes landmark block m and observation block m, as ``P(axis)`` gives
    them, and localises ``lm_idx`` to its block. Poses replicate. Returns
    (problem with the solved r, t and whole points, costs (iterations,)),
    the same on every rank."""
    group, n_shards, coord = mesh_axis(mesh, axis)
    dev = mesh_device(mesh)
    n_lm, n_obs = problem.points.shape[0], problem.kf_idx.shape[0]
    if n_lm % n_shards or n_obs % n_shards:
        raise ValueError(f"{n_lm} landmarks and {n_obs} observations must divide over "
                         f"{n_shards} ranks (partition_problem)")
    lm_l, obs_l = n_lm // n_shards, n_obs // n_shards
    lm_rows = slice(coord * lm_l, (coord + 1) * lm_l)
    obs_rows = slice(coord * obs_l, (coord + 1) * obs_l)
    # lm_idx arrives global; localise it to this rank's block. The padding
    # slots partition_problem adds carry global landmark 0, outside every
    # block but the first, and weight 0: the landmark sums drop them (as
    # the JAX package's scatters drop an out-of-bounds update), and their
    # gathers read any landmark of the block, so take it modulo there.
    local = problem.lm_idx[obs_rows].to(dev) - coord * lm_l
    p = BaProblem(
        r=problem.r.to(dev), t=problem.t.to(dev), points=problem.points[lm_rows].to(dev),
        kf_idx=problem.kf_idx[obs_rows].to(dev),
        lm_idx=torch.remainder(local, lm_l),
        uv=problem.uv[obs_rows].to(dev), valid=problem.valid[obs_rows].to(dev),
        fu=problem.fu.to(dev), fv=problem.fv.to(dev), cu=problem.cu.to(dev),
        cv=problem.cv.to(dev),
    )
    # Every rank adds its damping to the summed system: pre-divide by the
    # axis size so the reduced system carries the damping once (the
    # landmark blocks, which are not summed, carry the divided damping,
    # as in the JAX package).
    eff = torch.tensor(damping / n_shards, dtype=p.r.dtype, device=dev)
    plans = ba_plans(p.kf_idx, local, p.valid, p.r.shape[0], lm_l)  # once: the indices stay
    costs = []
    for _ in range(iterations):
        p, cost = _dist_step(p, eff, group, plans)
        costs.append(cost)
    points = all_gather_cat(p.points, group)
    costs = torch.stack(costs) if costs else torch.zeros((0,), dtype=p.r.dtype, device=dev)
    return dataclasses.replace(problem, r=p.r, t=p.t, points=points), costs


def partition_problem(problem: BaProblem, n_shards: int) -> BaProblem:
    """Host-side re-layout: round-robin landmarks to shards, re-indexing
    lm_idx to the re-laid-out points and padding observations per shard
    equally (numpy; the JAX package's arrays bit for bit).

    Returns a BaProblem, on the input's device, whose landmark and
    observation arrays concatenate the per-shard blocks (so block m of
    each is rank m's).
    """
    dev = problem.points.device
    pts = problem.points.cpu().numpy()
    kf = problem.kf_idx.cpu().numpy()
    lm = problem.lm_idx.cpu().numpy()
    uv = problem.uv.cpu().numpy()
    valid = problem.valid.cpu().numpy()
    n_lm = pts.shape[0]

    lm_pad = -(-n_lm // n_shards) * n_shards
    per_shard_lm = lm_pad // n_shards
    shard_of = np.arange(lm_pad) % n_shards
    local_of = np.arange(lm_pad) // n_shards

    obs_shard = shard_of[lm]
    counts = np.bincount(obs_shard, minlength=n_shards)
    per_shard_obs = int(counts.max())

    # Landmark g goes to shard g%S at local slot g//S.
    new_slot_of_lm = shard_of * per_shard_lm + local_of
    new_pts = np.zeros((lm_pad, 3), pts.dtype)
    new_pts[new_slot_of_lm[:n_lm]] = pts

    # Observation o of shard s lands at slot s*per_shard_obs + rank, where
    # rank is o's position among its shard's observations in input order.
    order = np.argsort(obs_shard, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts[:-1])])
    rank_sorted = np.arange(len(kf)) - np.repeat(starts, counts)
    slots = obs_shard[order] * per_shard_obs + rank_sorted

    new_kf = np.zeros((n_shards * per_shard_obs,), kf.dtype)
    new_lm = np.zeros((n_shards * per_shard_obs,), lm.dtype)
    new_uv = np.zeros((n_shards * per_shard_obs, 2), uv.dtype)
    new_valid = np.zeros((n_shards * per_shard_obs,), bool)
    new_kf[slots] = kf[order]
    new_lm[slots] = new_slot_of_lm[lm[order]]
    new_uv[slots] = uv[order]
    new_valid[slots] = valid[order]

    return dataclasses.replace(
        problem,
        points=torch.from_numpy(new_pts).to(dev),
        kf_idx=torch.from_numpy(new_kf).to(dev),
        lm_idx=torch.from_numpy(new_lm).to(dev),
        uv=torch.from_numpy(new_uv).to(dev),
        valid=torch.from_numpy(new_valid).to(dev),
    )
