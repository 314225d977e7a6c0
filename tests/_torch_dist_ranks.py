"""Rank bodies of tests/test_torch_dist.py: each runs in its own process
(spawned), joins a gloo group through a FileStore, runs the port's sharded
functions on the inputs the test wrote and saves what it got. Imports no
JAX."""
import dataclasses
import pathlib

import numpy as np
import torch
import torch.distributed as dist

from ethzasl_brisk_tpu_torch.ba.pose_graph import PoseGraph
from ethzasl_brisk_tpu_torch.ba.window import BaProblem
from ethzasl_brisk_tpu_torch.parallel import (
    AstFramePipeline,
    FramePipeline,
    init_process_group,
    make_mesh,
    sharded_knn_match,
)
from ethzasl_brisk_tpu_torch.parallel.dist_ba import partition_problem, solve_window_ba_sharded
from ethzasl_brisk_tpu_torch.parallel.dist_pg import optimize_pose_graph_sharded, partition_edges
from ethzasl_brisk_tpu_torch.pipeline import BriskFeature, BriskFeatureDetector

# The frame step's feature; its describe capacity comes per case.
FEATURE = dict(octaves=1, uniformity_radius=0.0, absolute_threshold=20.0, max_candidates=512,
               max_keypoints=128)
# The AST step's detector, its caps certified on the test frames, and its
# describe budget a frame.
AST_DETECTOR = dict(threshold=60, octaves=1, max_candidates_per_layer=1024)
AST_CAP = 28
BA_ITERATIONS, BA_DAMPING = 10, 1e-3
PG_ITERATIONS, PG_DAMPING = 15, 1e-5


def _fields(obj, prefix: str) -> dict:
    return {f"{prefix}{f.name}": np.asarray(getattr(obj, f.name).cpu().numpy())
            for f in dataclasses.fields(obj)}


def run_rank(rank: int, world: int, store: str, work: str, frame_caps: tuple) -> None:
    """One rank: knn, partitions, BA and pose graph over a (1, world) mesh;
    with ``frame_caps``, the frame step per describe budget and the AST
    step over a (world, 1) mesh."""
    torch.set_num_threads(1)
    work = pathlib.Path(work)
    inp = dict(np.load(work / "inputs.npz"))
    init_process_group(rank, world, store, "cpu")
    try:
        out = {}
        mesh = make_mesh(1, world, "cpu")
        idx, dist_k = sharded_knn_match(mesh, torch.from_numpy(inp["knn_q"]),
                                        torch.from_numpy(inp["knn_t"]),
                                        torch.from_numpy(inp["knn_tv"]), k=2)
        out["knn_idx"], out["knn_dist"] = idx.numpy(), dist_k.numpy()
        for tag in ("f32", "f64"):
            prob = BaProblem.from_numpy(
                {k.removeprefix(f"ba_{tag}_"): v for k, v in inp.items()
                 if k.startswith(f"ba_{tag}_")}, "cpu")
            part = partition_problem(prob, world)
            out.update(_fields(part, f"part_{tag}_"))
            solved, costs = solve_window_ba_sharded(mesh, part, iterations=BA_ITERATIONS,
                                                    damping=BA_DAMPING)
            out.update(_fields(solved, f"ba_{tag}_"))
            out[f"ba_{tag}_costs"] = costs.numpy()
            graph = PoseGraph.from_numpy(
                {k.removeprefix(f"pg_{tag}_"): v for k, v in inp.items()
                 if k.startswith(f"pg_{tag}_")}, "cpu")
            padded = partition_edges(graph, world)
            out.update(_fields(padded, f"edges_{tag}_"))
            g_out, pg_costs = optimize_pose_graph_sharded(mesh, padded, iterations=PG_ITERATIONS,
                                                          damping=PG_DAMPING)
            out[f"pg_{tag}_r"], out[f"pg_{tag}_t"] = g_out.r.numpy(), g_out.t.numpy()
            out[f"pg_{tag}_costs"] = pg_costs.numpy()
        frames = torch.from_numpy(inp["frames"])
        data_mesh = make_mesh(world, 1, "cpu") if frame_caps else None
        for cap in frame_caps:
            feature = BriskFeature(**FEATURE, describe_capacity=cap, device="cpu")
            pipe = FramePipeline(feature, "cpu", data_mesh)
            kps, desc, midx, mdist, diag = pipe.step(frames, with_diagnostics=True)
            out.update(_fields(kps, f"step{cap}_kp_"))
            out[f"step{cap}_desc"], out[f"step{cap}_midx"] = desc.numpy(), midx.numpy()
            out[f"step{cap}_mdist"] = mdist.numpy()
            out[f"step{cap}_describable"] = np.asarray(int(diag["describable"]))
            out[f"step{cap}_ok"] = diag["detect"].ok.numpy()
        if frame_caps:
            det = BriskFeatureDetector(**AST_DETECTOR, device="cpu")
            ast = AstFramePipeline(det, "cpu", describe_capacity=AST_CAP, mesh=data_mesh)
            kps, desc, midx, mdist, diag = ast.step(frames, with_diagnostics=True)
            out.update(_fields(kps, "ast_kp_"))
            out["ast_desc"], out["ast_midx"], out["ast_mdist"] = (
                desc.numpy(), midx.numpy(), mdist.numpy())
            out["ast_describable"] = np.asarray(int(diag["describable"]))
            out["ast_ok"] = diag["detect"].ok.numpy()
            try:
                pipe.step(frames[:world - 1])
            except ValueError:
                out["uneven_batch_raises"] = np.asarray(True)
        np.savez(work / f"out_{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
