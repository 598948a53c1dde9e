"""Training checkpoint and resume (the port's counterpart of
``opsagent_tpu/training/checkpoint.py``).

Layout: ``<dir>/step_<N>/`` as in JAX, each holding one ``state.pt``:
``{"params": model.state_dict(), "opt_state": optimizer.state_dict()}``
written with ``torch.save`` and read back with ``weights_only=True`` (the
machine beside the card has no orbax). A save writes into a temporary
directory beside the target and renames it into place, so a crash mid-save
leaves the earlier steps intact and ``latest_step`` never sees a
half-written one, as orbax's rename does. JAX's orbax checkpoints are not
read.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile

import torch

STATE_FILE = "state.pt"


def _step_dir(dirpath: str, step: int) -> str:
    return os.path.join(os.path.abspath(dirpath), f"step_{step}")


def latest_step(dirpath: str) -> int | None:
    """Highest completed checkpoint step in ``dirpath``, or None."""
    if not os.path.isdir(dirpath):
        return None
    steps = [
        int(m.group(1))
        for name in os.listdir(dirpath)
        if (m := re.fullmatch(r"step_(\d+)", name))
    ]
    return max(steps) if steps else None


def save_train_state(
    dirpath: str, step: int, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
) -> str:
    """Write the parameters and the optimizer state for ``step``; returns
    the step's path. An earlier save of the same step is replaced."""
    path = _step_dir(dirpath, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".step_{step}.", dir=os.path.dirname(path))
    try:
        torch.save(
            {"params": model.state_dict(), "opt_state": optimizer.state_dict()},
            os.path.join(tmp, STATE_FILE),
        )
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def restore_train_state(
    dirpath: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
    step: int | None = None,
) -> tuple[torch.nn.Module, torch.optim.Optimizer, int]:
    """Load ``step`` (default: the latest) into ``model`` and ``optimizer``,
    made as the saving run made them (``init_train_state``), in place;
    returns (model, optimizer, step). Tensors load onto the devices the
    model's parameters are on."""
    if step is None:
        step = latest_step(dirpath)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {dirpath}")
    device = next(model.parameters()).device
    state = torch.load(os.path.join(_step_dir(dirpath, step), STATE_FILE),
                       map_location=device, weights_only=True)
    with torch.no_grad():
        model.load_state_dict(state["params"])
    optimizer.load_state_dict(state["opt_state"])
    return model, optimizer, step
