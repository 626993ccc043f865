"""Checkpoint and resume for long sampling runs.

Counterpart of ``mcmcglm_tpu/checkpoint.py``.  The recovery unit is (the
sampler state, the collected samples, the step counter), saved
periodically; a restart resumes from the last committed step.  Every
state of the port carries its full random state (the free-running
engines' Philox ``key`` and pass index ``ctr``, the lockstep engine's key
and sweep, the fused engine's seed and sweep), so a run that is saved,
restored and continued equals the run that was never interrupted, bit for
bit.

Storage is ``torch.save``, loaded back with ``torch.load(...,
weights_only=True)`` (no pickled code runs on restore).  The JAX package
writes orbax checkpoints, which this module cannot read.  Layout:

    <directory>/<step>/rank-<r>-of-<W>.pt   one file per rank
    <directory>/<step>/COMMITTED            written by rank 0 last

Each rank writes its file under a temporary name and renames it; after a
barrier of every rank, rank 0 writes the commit marker.  Only committed
steps count (:meth:`CheckpointManager.latest_step`), so a step that a
crash interrupted is never restored: the atomicity orbax gave.

A state is any NamedTuple of tensors (and ints, floats, bools, strings,
None, dicts), or a tuple, list or dict of them: ``FreeRunState``,
``QuantileState``, ``DoublingState``, ``FusedState``, ``ChainState``,
``ChainMoments``, ``ESSState``.  Restore checks the template's classes,
field names, shapes and dtypes, and puts each tensor on the template's
device.  A lockstep ``ChainState`` that holds warmup-adapted widths runs
on a fresh ``CGGibbs`` after ``warmup(state, 0)`` (the engine holds the
sampling mode, the state only the widths).
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from .parallel.distributed import sync_global_devices

__all__ = ["CheckpointManager", "CHECKPOINT_FORMAT"]

# Payload format version.  Bump whenever a state field changes MEANING
# (not just structure — the restore checks structure itself): a silently
# restored stale semantic would contaminate every post-restore draw with
# no error.  History:
#   1: rounds 1-2 (freerun ld0 = ABSOLUTE log density)
#   2: round 3+   (freerun ld0 = RELATIVE log density — eta-independent
#      per-observation constants dropped; restoring a v1 ld0 would bias
#      the first slice test per coordinate by those constants)
CHECKPOINT_FORMAT = 2

_COMMIT = "COMMITTED"
_LEAVES = (int, float, bool, str, type(None))


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _encode(x):
    """A tree of tensors -> plain containers of CPU tensors that
    ``torch.load(weights_only=True)`` reads back."""
    if torch.is_tensor(x):
        return x.detach().cpu()
    if _is_namedtuple(x):
        return {"namedtuple": type(x).__name__,
                "fields": {k: _encode(v) for k, v in zip(x._fields, x)}}
    if isinstance(x, dict):
        return {"dict": {k: _encode(v) for k, v in x.items()}}
    if isinstance(x, (tuple, list)):
        return {"seq": [_encode(v) for v in x],
                "tuple": isinstance(x, tuple)}
    if isinstance(x, _LEAVES):
        return {"leaf": x}
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def _decode(enc, template, path="state"):
    """The saved tree ``enc`` rebuilt on the structure of ``template``:
    classes, field names, shapes and dtypes must agree."""
    def fail(what):
        raise ValueError(f"checkpoint does not match the template at "
                         f"{path}: {what}")

    if torch.is_tensor(template):
        if not torch.is_tensor(enc):
            fail(f"a tensor expected, {type(enc).__name__} found")
        if enc.shape != template.shape or enc.dtype != template.dtype:
            fail(f"saved {tuple(enc.shape)} {enc.dtype}, template "
                 f"{tuple(template.shape)} {template.dtype}")
        return enc.to(template.device)
    if not isinstance(enc, dict):
        fail(f"a {type(template).__name__} expected")
    if _is_namedtuple(template):
        if enc.get("namedtuple") != type(template).__name__:
            fail(f"saved {enc.get('namedtuple')}, template "
                 f"{type(template).__name__}")
        if list(enc["fields"]) != list(template._fields):
            fail(f"saved fields {list(enc['fields'])}, template "
                 f"{list(template._fields)}")
        return type(template)(*[
            _decode(enc["fields"][k], v, f"{path}.{k}")
            for k, v in zip(template._fields, template)])
    if isinstance(template, dict):
        if "dict" not in enc or set(enc["dict"]) != set(template):
            fail(f"saved keys {sorted(enc.get('dict', {}))}, template "
                 f"{sorted(template)}")
        return {k: _decode(enc["dict"][k], v, f"{path}[{k!r}]")
                for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        if "seq" not in enc or len(enc["seq"]) != len(template):
            fail(f"a sequence of {len(template)} expected")
        out = [_decode(e, t, f"{path}[{i}]")
               for i, (e, t) in enumerate(zip(enc["seq"], template))]
        return tuple(out) if isinstance(template, tuple) else out
    if "leaf" not in enc or type(enc["leaf"]) is not type(template):
        fail(f"a {type(template).__name__} value expected")
    return enc["leaf"]


def _rank_world():
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class CheckpointManager:
    """Per-rank ``torch.save`` checkpoints of (state, samples, step).

    ``max_to_keep`` committed steps are kept; older ones are deleted by
    rank 0 after each commit.  In a process group every rank calls
    :meth:`save` with its own state (its shard).
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

    def _file(self, step: int) -> str:
        rank, world = _rank_world()
        return os.path.join(self.directory, str(int(step)),
                            f"rank-{rank}-of-{world}.pt")

    def _committed_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(
                    os.path.join(self.directory, name, _COMMIT)):
                steps.append(int(name))
        return sorted(steps)

    def save(self, step: int, state: Any, samples=None) -> None:
        """Write this rank's (state, samples) at ``step`` and, once every
        rank has written, commit the step."""
        if samples is not None and not torch.is_tensor(samples):
            samples = np.asarray(samples)
        payload = {
            "format": CHECKPOINT_FORMAT,
            "step": int(step),
            "state": _encode(state),
            "samples": (None if samples is None
                        else torch.as_tensor(samples).detach().cpu()),
            "samples_numpy": isinstance(samples, np.ndarray),
        }
        path = self._file(step)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp-{os.getpid()}"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        sync_global_devices(f"checkpoint {step} written")
        rank, world = _rank_world()
        if rank == 0:
            marker = os.path.join(os.path.dirname(path), _COMMIT)
            with open(marker + ".tmp", "w") as fh:
                fh.write(f"{world}\n")
            os.replace(marker + ".tmp", marker)
            for old in self._committed_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        sync_global_devices(f"checkpoint {step} committed")

    def latest_step(self) -> Optional[int]:
        """The newest committed step, or None."""
        steps = self._committed_steps()
        return steps[-1] if steps else None

    def restore(self, state_template: Any, step: Optional[int] = None):
        """(step, state, samples) of the newest committed step (or
        ``step``), or None when there is none.  ``state_template`` (e.g. a
        fresh ``init`` state of the same engine) gives the structure and
        the devices."""
        steps = self._committed_steps()
        if step is None:
            if not steps:
                return None
            step = steps[-1]
        elif int(step) not in steps:
            raise FileNotFoundError(
                f"no committed checkpoint at step {step} in "
                f"{self.directory} (committed: {steps})")
        step = int(step)
        path = self._file(step)
        if not os.path.exists(path):
            with open(os.path.join(self.directory, str(step), _COMMIT)) as fh:
                saved = fh.read().strip()
            raise FileNotFoundError(
                f"no checkpoint file {path}: step {step} was written by a "
                f"world of {saved} ranks, this one has {_rank_world()[1]}"
            )
        payload = torch.load(path, map_location="cpu", weights_only=True)
        if "format" not in payload:
            raise ValueError(
                f"checkpoint at step {step} could not be restored — "
                "likely written before format tagging (format "
                f"{CHECKPOINT_FORMAT} required; freerun ld0 semantics "
                "changed from absolute to relative log density)"
            )
        fmt = int(payload["format"])
        if fmt != CHECKPOINT_FORMAT:
            raise ValueError(
                f"checkpoint format {fmt} != supported {CHECKPOINT_FORMAT}; "
                "state field semantics differ (see CHECKPOINT_FORMAT "
                "history) — refusing a silently-biased restore"
            )
        state = _decode(payload["state"], state_template)
        samples = payload["samples"]
        if samples is not None and payload["samples_numpy"]:
            samples = samples.numpy()
        return int(payload["step"]), state, samples

    def close(self) -> None:
        """Nothing is held open between calls (the JAX package's manager
        closes orbax's); kept so code written for it runs unchanged."""
