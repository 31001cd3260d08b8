"""Export a port checkpoint as a ``.pt`` file of the original PyTorch GAOT.

    python -m gaot_torch.tools.export_torch_ckpt <config.json> [ckpt_path] [out.pt]

Counterpart of ``scripts/export_torch_ckpt.py``, the inverse of
``import_torch_ckpt``: builds the model from the config, loads the port
checkpoint (default: the config's ``path.ckpt_path``) strictly and saves
``{"model": state_dict}`` with the full weights (a checkpoint of a
tensor-parallel run holds them joined), which the reference's
``load_ckpt`` reads. The default ``out`` is ``model.pt`` beside the
checkpoint.
"""
from __future__ import annotations

import os
import sys
from typing import Optional

import torch


def main(config_path: str, ckpt_path: Optional[str] = None,
         out: Optional[str] = None) -> str:
    """Export the checkpoint; returns the file written."""
    from ..cli import load_run_config, make_trainer

    _, cfg = load_run_config(config_path)
    cfg.setup.train = False
    if ckpt_path:
        cfg.path.ckpt_path = ckpt_path
    trainer = make_trainer(cfg)
    trainer.load_ckpt()
    sd = {k: v.detach().cpu() for k, v in trainer.full_state().items()}
    out = out or os.path.join(os.path.dirname(os.path.abspath(cfg.path.ckpt_path)),
                              "model.pt")
    torch.save({"model": sd}, out)
    print(f"Exported {len(sd)} tensors from {cfg.path.ckpt_path} to {out}")
    return out


if __name__ == "__main__":
    if not 2 <= len(sys.argv) <= 4:
        print(__doc__)
        sys.exit(1)
    main(*sys.argv[1:])
