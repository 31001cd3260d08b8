"""Command-line tools: checkpoint import from and export to the original
PyTorch GAOT's ``.pt`` files (``python -m gaot_torch.tools.import_torch_ckpt``,
``python -m gaot_torch.tools.export_torch_ckpt``)."""
