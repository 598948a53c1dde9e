"""How the benchmark meets the port: for each model family, the port's
``ModelConfig`` of a configuration file (its preset), a check that it has
the published sizes the file states, and the writing of the benchmark's
seeded weights into the port's parameters by name. One module per family,
found by the configuration's ``family``."""

from __future__ import annotations

import torch


def port_config(conf: dict):
    """The port's ``ModelConfig``: the preset ``conf["preset"]``."""
    from opsagent_tpu_torch.models.config import get_config_preset

    return get_config_preset(conf["preset"])


def expect(pairs: dict[str, tuple]) -> None:
    """Raise unless each (port value, published value) pair agrees."""
    bad = {k: v for k, v in pairs.items() if v[0] != v[1]}
    if bad:
        raise ValueError(f"the port's preset differs from the configuration: {bad}")


def write(model: torch.nn.Module, specs: dict, maker, put) -> None:
    """Draw every published tensor of ``specs`` and hand it to
    ``put(params, name, tensor)``, which copies it into the port's
    parameters; every parameter of the port must be written."""
    params = dict(model.named_parameters())
    written: set[str] = set()
    with torch.inference_mode():
        for group in specs.values():
            for spec in group:
                written |= put(params, spec.name, maker.make(spec))
    missing = sorted(set(params) - written)
    if missing:
        raise ValueError(f"port parameters the benchmark does not make: {missing[:8]}")
