"""Checkpoint and resume of BA / map state and of the keyframed VO loop
(port of ``utils/checkpoint.py``, with ``torch.save`` files in place of
Orbax).

The reference has no failure-detection or elastic layer (it is a
single-process library; SURVEY.md section 5). What stands in for one is a
checkpoint of the mapping state (keyframe poses, landmarks and the
observation structure), so that a long sequence run survives a
preemption: restore the latest step and continue from the next frame.

* ``MapState`` is a frozen dataclass of fixed-capacity tensors, the same
  static-shape discipline as the BA solver.
* ``CheckpointManager`` writes one file per step with ``torch.save``, to a
  temporary name first and then ``os.replace``, so a crash never leaves
  half a step, and keeps the last ``max_to_keep`` steps. Saves are
  synchronous (``wait`` has nothing to wait for). Files are read with
  ``torch.load(weights_only=True)``: a state holds tensors, numbers and
  plain containers only (dataclasses are saved as dicts of their fields).
* ``restore_or_init`` is the resume entry: returns (state, next_step).

``pack_vo_loop_state`` and ``unpack_vo_loop_state`` carry the keyframed
loop's state (``vo/sequence.run_keyframed``, ``tools/kitti_eval.py``'s
loop) with the JAX package's field names and shapes. Three things differ:
``key`` is the RANSAC source's state (``torch.Generator.get_state()``, or
the cursor of a draw that replays samples) in place of a JAX PRNG key;
the trajectory stays float64, the loop's own dtype, where the JAX package
stores float32 (a float32 round trip would move a resumed run off an
uninterrupted one); and descriptors are the port's int32 words, the JAX
package's uint32 words as bit patterns.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import re

import numpy as np
import torch

from ethzasl_brisk_tpu_torch.core.device import resolve_device
from ethzasl_brisk_tpu_torch.core.keypoints import KeyPoints

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")
_KP_FIELDS = ("x", "y", "size", "angle", "response", "octave", "valid")


@dataclasses.dataclass(frozen=True)
class MapState:
    """Fixed-capacity sliding map: keyframe poses + landmarks + tracks.

    Everything a resume needs to continue the frame loop at ``frame_idx``.
    """

    r: torch.Tensor          # (K, 3, 3) keyframe camera-from-world rotations
    t: torch.Tensor          # (K, 3)
    kf_frame: torch.Tensor   # (K,) int32 source frame index, -1 = empty
    points: torch.Tensor     # (L, 3) world landmarks
    kf_idx: torch.Tensor     # (O,) int32 observation -> keyframe slot
    lm_idx: torch.Tensor     # (O,) int32 observation -> landmark slot
    uv: torch.Tensor         # (O, 2) f32 observed pixels
    valid: torch.Tensor      # (O,) bool
    frame_idx: torch.Tensor  # () int32 next frame to process

    @staticmethod
    def empty(n_kf: int, n_lm: int, n_obs: int,
              device: str | torch.device = "cuda") -> "MapState":
        dev = resolve_device(device)
        f32, i32 = torch.float32, torch.int32
        return MapState(
            r=torch.eye(3, dtype=f32, device=dev).expand(n_kf, 3, 3).clone(),
            t=torch.zeros((n_kf, 3), dtype=f32, device=dev),
            kf_frame=torch.full((n_kf,), -1, dtype=i32, device=dev),
            points=torch.zeros((n_lm, 3), dtype=f32, device=dev),
            kf_idx=torch.zeros((n_obs,), dtype=i32, device=dev),
            lm_idx=torch.zeros((n_obs,), dtype=i32, device=dev),
            uv=torch.zeros((n_obs, 2), dtype=f32, device=dev),
            valid=torch.zeros((n_obs,), dtype=torch.bool, device=dev),
            frame_idx=torch.zeros((), dtype=i32, device=dev),
        )

    def to_numpy(self) -> dict:
        """Host numpy arrays keyed by field name."""
        return {f.name: getattr(self, f.name).cpu().numpy() for f in dataclasses.fields(self)}

    @staticmethod
    def from_numpy(arrays, device: str | torch.device = "cuda") -> "MapState":
        """A state from host arrays keyed by field name (``np.asarray`` of
        each field of the JAX ``MapState`` does)."""
        dev = resolve_device(device)
        return MapState(**{f.name: _tensor(arrays[f.name], dev)
                           for f in dataclasses.fields(MapState)})


def _tensor(x, device: torch.device) -> torch.Tensor:
    """A tensor on ``device`` from a tensor, a number or an array; uint32
    arrays (the JAX package's descriptor words) become int32 bit patterns."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a)).to(device)


def _to_saved(tree):
    """The tree as ``torch.load(weights_only=True)`` reads it back: CPU
    tensors, numbers and plain containers; dataclasses become dicts."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, np.ndarray | np.generic):
        return _tensor(tree, torch.device("cpu"))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: _to_saved(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: _to_saved(v) for k, v in tree.items()}
    if isinstance(tree, tuple | list):
        return type(tree)(_to_saved(v) for v in tree)
    if tree is None or isinstance(tree, bool | int | float | str):
        return tree
    raise TypeError(f"a checkpoint holds tensors, numbers and containers, not {type(tree)}")


def _like(template, saved, where: str = "state"):
    """``saved`` in the structure of ``template``: each tensor takes the
    template tensor's dtype and device and must have its shape."""
    if isinstance(template, torch.Tensor):
        got = _tensor(saved, template.device).to(template.dtype)
        if got.shape != template.shape:
            raise ValueError(f"{where}: saved shape {tuple(got.shape)}, template "
                             f"{tuple(template.shape)}")
        return got
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return type(template)(**{
            f.name: _like(getattr(template, f.name), saved[f.name], f"{where}.{f.name}")
            for f in dataclasses.fields(template)
        })
    if isinstance(template, dict):
        return {k: _like(v, saved[k], f"{where}[{k!r}]") for k, v in template.items()}
    if isinstance(template, tuple | list):
        return type(template)(_like(t, s, f"{where}[{i}]")
                              for i, (t, s) in enumerate(zip(template, saved, strict=True)))
    return saved


class CheckpointManager:
    """Save and restore a tree of tensors by step, one file a step."""

    def __init__(self, directory, max_to_keep: int = 3):
        self.directory = pathlib.Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> pathlib.Path:
        return self.directory / f"step_{int(step)}.pt"

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := _STEP_FILE.match(p.name)))

    def save(self, step: int, state) -> None:
        path = self._path(step)
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        torch.save(_to_saved(state), tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            self._path(old).unlink(missing_ok=True)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load(self, step: int):
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def restore(self, step: int, template):
        """Restore into the structure, dtypes and devices of ``template``."""
        return _like(template, self._load(step))

    def restore_latest(self):
        """The latest step without a template: (state, step) or (None,
        None). Dataclasses come back as plain dicts, tensors on the CPU."""
        step = self.latest_step()
        if step is None:
            return None, None
        return self._load(step), int(step)

    def restore_or_init(self, template):
        """Resume entry: (state, next_step). Fresh start -> (template, 0)."""
        step = self.latest_step()
        if step is None:
            return template, 0
        return self.restore(step, template), int(step) + 1

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def close(self) -> None:
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def state_from_ba_problem(problem, kf_frame, frame_idx) -> MapState:
    """Pack a ba.window.BaProblem + bookkeeping into a MapState on the
    problem's device."""
    dev = problem.r.device
    return MapState(
        r=problem.r, t=problem.t,
        kf_frame=torch.as_tensor(np.asarray(kf_frame), device=dev).to(torch.int32),
        points=problem.points,
        kf_idx=problem.kf_idx.to(torch.int32), lm_idx=problem.lm_idx.to(torch.int32),
        uv=problem.uv, valid=problem.valid,
        frame_idx=torch.tensor(int(frame_idx), dtype=torch.int32, device=dev),
    )


def trajectory_to_state(poses_wfc, frame_idx, capacity=None) -> dict:
    """Checkpointable dict for a plain trajectory run (sequence_eval):
    (N, 4, 4) world-from-camera poses padded to ``capacity``, float64."""
    poses = np.asarray(poses_wfc, np.float64)
    n = poses.shape[0]
    cap = capacity or n
    out = np.tile(np.eye(4), (cap, 1, 1))
    out[:n] = poses
    return {
        "poses": torch.from_numpy(out),
        "n": torch.tensor(n, dtype=torch.int32),
        "frame_idx": torch.tensor(int(frame_idx), dtype=torch.int32),
    }


def pack_vo_loop_state(
    *, poses, frame_idx, key, prev, kf, window: int, n_frames: int,
    n_ba_runs: int,
) -> dict:
    """Snapshot the keyframed frame loop's state as one dict of CPU tensors.

    ``kf`` is the loop's keyframe list (dicts with frame/kp/desc/
    match_to_prev); only the trailing ``window`` entries matter for future
    window-BA solves, so only those are saved (stacked). ``key`` is the
    RANSAC source's state (a tensor).
    """
    cpu = torch.device("cpu")
    traj = trajectory_to_state(poses, frame_idx, capacity=n_frames)
    tail = kf[-window:]
    n_tail = len(tail)
    kp_cap = int(prev[0].x.shape[-1]) if prev else 0

    def stack_field(get, fill, dtype):
        out = np.full((window, kp_cap), fill, dtype)
        for i, e in enumerate(tail):
            row = np.asarray(get(e))
            out[i, : row.shape[-1]] = row
        return torch.from_numpy(out)

    state = dict(
        **traj,
        key=_tensor(key, cpu),
        n_ba_runs=torch.tensor(n_ba_runs, dtype=torch.int32),
        n_kf_tail=torch.tensor(n_tail, dtype=torch.int32),
        kf_frame=torch.tensor([e["frame"] for e in tail] + [-1] * (window - n_tail),
                              dtype=torch.int32),
    )
    if prev is not None:
        state["prev_kp"] = {f: getattr(prev[0], f).cpu() for f in _KP_FIELDS}
        state["prev_desc"] = prev[1].cpu()
    if tail:
        for f in ("x", "y", "size", "angle", "response"):
            state[f"kf_{f}"] = stack_field(lambda e, f=f: getattr(e["kp"], f).cpu(), 0.0,
                                           np.float32)
        state["kf_octave"] = stack_field(lambda e: e["kp"].octave.cpu(), 0, np.int32)
        state["kf_valid"] = stack_field(lambda e: e["kp"].valid.cpu(), False, bool)
        dw = int(tail[0]["desc"].shape[-1])
        descs = np.zeros((window, kp_cap, dw), np.int32)
        match_b = np.zeros((window, kp_cap), np.int32)
        match_m = np.zeros((window, kp_cap), bool)
        has_match = np.zeros((window,), bool)
        for i, e in enumerate(tail):
            descs[i] = e["desc"].cpu().numpy()
            if e["match_to_prev"] is not None:
                b, m = e["match_to_prev"]
                match_b[i] = np.asarray(b)
                match_m[i] = np.asarray(m)
                has_match[i] = True
        state["kf_desc"] = torch.from_numpy(descs)
        state["kf_match_b"] = torch.from_numpy(match_b)
        state["kf_match_m"] = torch.from_numpy(match_m)
        state["kf_has_match"] = torch.from_numpy(has_match)
    return state


def unpack_vo_loop_state(state: dict, generator: torch.Generator | None = None, draw=None,
                         device: str | torch.device = "cuda"):
    """Inverse of pack_vo_loop_state, onto ``device``; ``state`` may hold
    tensors or arrays (a JAX-written state restored by Orbax too).

    Returns (poses list, frame_idx, key, prev, kf list, n_ba_runs). The key
    goes back into its source: ``draw.cursor`` when a draw is given, else
    ``generator.set_state`` when a generator is.
    """
    dev = resolve_device(device)

    def t(x):
        return _tensor(x, dev)

    def host(x):
        return _tensor(x, torch.device("cpu")).numpy()

    n = int(host(state["n"]))
    poses = [np.array(p, np.float64) for p in host(state["poses"])[:n]]
    frame_idx = int(host(state["frame_idx"]))
    n_ba_runs = int(host(state["n_ba_runs"]))
    key = state["key"]
    if draw is not None:
        draw.cursor = int(host(key))
    elif generator is not None:
        generator.set_state(_tensor(key, torch.device("cpu")).to(torch.uint8))
    prev = None
    if "prev_kp" in state:
        pk = state["prev_kp"]
        prev = (KeyPoints(**{f: t(pk[f]) for f in _KP_FIELDS}), t(state["prev_desc"]))
    kf = []
    if "kf_desc" in state:
        n_tail = int(host(state["n_kf_tail"]))
        for i in range(n_tail):
            kp = KeyPoints(**{f: t(state[f"kf_{f}"][i]) for f in _KP_FIELDS})
            match = None
            if bool(host(state["kf_has_match"])[i]):
                match = (host(state["kf_match_b"])[i], host(state["kf_match_m"])[i])
            kf.append(dict(frame=int(host(state["kf_frame"])[i]), kp=kp,
                           desc=t(state["kf_desc"][i]), match_to_prev=match))
    return poses, frame_idx, key, prev, kf, n_ba_runs
