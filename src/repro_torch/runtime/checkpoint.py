"""Step-scoped checkpointing with atomic publish and a versioned manifest.

Counterpart of ``repro.runtime.checkpoint``, with the same file layout and
manifest. Saves the training state (params, optimizer, data cursor) with
every tensor moved to host numpy (a bfloat16 one, which numpy cannot
hold, as the int16 view of its bits); ``restore`` puts the arrays back as
tensors of the same dtype and bits on the manager's device. Writes go to
a temp file, are fsynced and
renamed into place, so a crash mid-save never corrupts the latest
checkpoint: a restart always reads the newest *complete* step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pickle
import tempfile
import time

import numpy as np
import torch

from repro_torch.tree import tree_map

# dtypes numpy has no type for, saved as an integer view of the same width
_BIT_VIEWS = {torch.bfloat16: torch.int16}


@dataclasses.dataclass(frozen=True)
class _Bits:
    """A saved tensor of a dtype numpy lacks: its name and its bits."""
    dtype: str
    bits: np.ndarray


def _to_host(x):
    if not isinstance(x, torch.Tensor):
        return x
    x = x.detach().cpu()
    if x.dtype in _BIT_VIEWS:
        return _Bits(str(x.dtype).removeprefix("torch."),
                     x.view(_BIT_VIEWS[x.dtype]).numpy())
    return x.numpy()


def _to_device(x, device: torch.device):
    if isinstance(x, _Bits):
        return torch.from_numpy(x.bits).view(getattr(torch, x.dtype)).to(
            device)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x).to(device)
    return x


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 device: str | torch.device = "cuda"):
        self.dir = directory
        self.keep = keep
        self.device = torch.device(device)
        os.makedirs(directory, exist_ok=True)

    def _manifest_path(self):
        return os.path.join(self.dir, "manifest.json")

    def _read_manifest(self) -> dict:
        try:
            with open(self._manifest_path()) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return {"steps": []}

    def save(self, step: int, state: dict, extra_meta: dict | None = None):
        host_state = tree_map(_to_host, state)
        payload = pickle.dumps(host_state, protocol=pickle.HIGHEST_PROTOCOL)
        fname = f"step_{step:010d}.ckpt"
        # atomic publish: write temp, fsync, rename
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, os.path.join(self.dir, fname))
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        man = self._read_manifest()
        man["steps"] = sorted(set(man["steps"] + [step]))
        man["updated"] = time.time()
        if extra_meta:
            man.setdefault("meta", {})[str(step)] = extra_meta
        # retention
        while len(man["steps"]) > self.keep:
            old = man["steps"].pop(0)
            with contextlib.suppress(FileNotFoundError):
                os.unlink(os.path.join(self.dir, f"step_{old:010d}.ckpt"))
        with open(self._manifest_path(), "w") as f:
            json.dump(man, f)

    def restore(self, step: int) -> dict | None:
        path = os.path.join(self.dir, f"step_{step:010d}.ckpt")
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            host_state = pickle.load(f)
        return tree_map(lambda x: _to_device(x, self.device), host_state)

    def restore_latest(self) -> dict | None:
        man = self._read_manifest()
        if not man["steps"]:
            return None
        return self.restore(man["steps"][-1])

    def latest_step(self) -> int | None:
        man = self._read_manifest()
        return man["steps"][-1] if man["steps"] else None
