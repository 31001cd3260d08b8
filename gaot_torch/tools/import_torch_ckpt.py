"""Import a trained checkpoint of the original PyTorch GAOT into the port.

    python -m gaot_torch.tools.import_torch_ckpt <config.json> <reference.pt> [out]

Counterpart of ``scripts/import_torch_ckpt.py``. Builds the trainer (and
model) from the config, reads the reference ``.pt`` file (saved as
``{"model": state_dict}``), strips the ``module.`` prefix of a
DataParallel model and drops the ``.rotary_emb.`` keys (the rotary
embedding's fixed inverse frequencies, which the port computes), loads the
result strictly (a config that does not match raises instead of importing
part of a model), and writes a port checkpoint (``gaot_torch/train/
checkpoint.py``) at update count 0 with a fresh optimizer state to ``out``
(default: the config's ``path.ckpt_path``, relative to the config's folder
as the CLI reads it). The port's parameters carry the reference's names,
so no weight is renamed or transposed.

The dataset the config names must be present: the model's channel counts
come from it, as in training.
"""
from __future__ import annotations

import sys
from typing import Dict, Optional

import torch


def reference_state_dict(raw: Dict) -> Dict[str, torch.Tensor]:
    """The model weights of a reference checkpoint (``{"model": sd}`` or a
    bare state dict) under the port's names."""
    out = {}
    for k, v in raw.get("model", raw).items():
        if k.startswith("module."):
            k = k[len("module."):]
        if ".rotary_emb." in k:
            continue
        out[k] = torch.as_tensor(v)
    return out


def main(config_path: str, ckpt_path: str, out: Optional[str] = None) -> str:
    """Import ``ckpt_path``; returns the checkpoint file written."""
    from ..cli import load_run_config, make_trainer
    from ..train.checkpoint import save_checkpoint

    _, cfg = load_run_config(config_path)
    cfg.setup.train = False
    trainer = make_trainer(cfg)
    sd = reference_state_dict(torch.load(ckpt_path, map_location="cpu",
                                         weights_only=True))
    trainer.load_full_weights(sd)
    fname = save_checkpoint(out or cfg.path.ckpt_path, trainer.full_state(),
                            trainer.optimizer.state_dict(), 0)
    n = sum(v.numel() for v in sd.values())
    print(f"Imported {len(sd)} tensors ({n} params) from {ckpt_path} into {fname}")
    return fname


if __name__ == "__main__":
    if not 3 <= len(sys.argv) <= 4:
        print(__doc__)
        sys.exit(1)
    main(*sys.argv[1:])
