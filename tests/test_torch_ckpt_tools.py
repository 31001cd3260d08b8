"""The port's checkpoint tools (``gaot_torch/tools/``) on the CPU, against a
reference-shaped ``.pt`` file: the JAX package's weights through
``flax_to_torch_state_dict`` (the original PyTorch GAOT's names), with the
``module.`` prefix of a DataParallel model and the rotary embedding's
``.rotary_emb.inv_freq`` keys added, as the reference saves them.

- import writes a port checkpoint at update count 0 whose weights are the
  file's bit for bit; export writes ``{"model": state_dict}`` that equals
  them bit for bit, and importing the export gives the same checkpoint;
- the JAX package's ``torch_to_flax_params`` reads the export back to its
  own weights, so a file made by the port goes to ``scripts/``' import;
- a file that does not match the config raises (strict);
- both run as ``python -m`` commands.
"""
import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_parallel import _config, _jax_trainer, _write  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(config path, config, the JAX trainer, the reference file, its
    weights under the port's names)."""
    import jax

    from gaot_tpu.utils.torch_interop import flax_to_torch_state_dict

    tmp = tmp_path_factory.mktemp("tools")
    cfg = _config(tmp, "tools")
    jt = _jax_trainer(cfg)
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in
          flax_to_torch_state_dict(jax.tree.map(np.asarray, jt.params)).items()}
    raw = {f"module.{k}": v for k, v in sd.items()}
    for i in range(cfg["model"]["args"]["transformer"]["num_layers"] // 2):
        raw[f"module.processor.encoder_layers.{i}.attn.rotary_emb.inv_freq"] = \
            torch.arange(4, dtype=torch.float32)
    ref = tmp / "reference.pt"
    torch.save({"model": raw}, ref)
    return _write(tmp, cfg, "tools"), cfg, jt, str(ref), sd


def _equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_import_export_round_trip_bit_for_bit(reference, tmp_path):
    from gaot_torch.tools import export_torch_ckpt, import_torch_ckpt
    from gaot_tpu.utils.torch_interop import torch_to_flax_params

    cfg_path, _, jt, ref, sd = reference
    ck = import_torch_ckpt.main(cfg_path, ref, str(tmp_path / "imported"))
    state = torch.load(ck, weights_only=True)
    assert state["step"] == 0 and not state["optimizer"]["state"]
    _equal(state["model"], sd)

    out = export_torch_ckpt.main(cfg_path, str(tmp_path / "imported"),
                                 str(tmp_path / "exported.pt"))
    exported = torch.load(out, weights_only=True)
    assert list(exported) == ["model"]
    _equal(exported["model"], sd)
    again = import_torch_ckpt.main(cfg_path, out, str(tmp_path / "again"))
    _equal(torch.load(again, weights_only=True)["model"], sd)

    # the JAX package reads the port's export back to its own weights
    import jax

    back = torch_to_flax_params(exported["model"], jt.params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jt.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("fault", ["missing", "unexpected"])
def test_import_is_strict(reference, tmp_path, fault):
    from gaot_torch.tools import import_torch_ckpt

    cfg_path, _, _, _, sd = reference
    bad = dict(sd)
    if fault == "missing":
        bad.pop(sorted(bad)[0])
    else:
        bad["decoder.extra.weight"] = torch.zeros(2)
    torch.save({"model": bad}, tmp_path / "bad.pt")
    with pytest.raises(RuntimeError, match="Missing key|Unexpected key"):
        import_torch_ckpt.main(cfg_path, str(tmp_path / "bad.pt"),
                               str(tmp_path / "bad_out"))
    assert not (tmp_path / "bad_out.pt").exists()


def test_tools_run_as_modules(reference, tmp_path):
    cfg_path, cfg, _, ref, sd = reference
    env = dict(os.environ, PYTHONPATH=ROOT)
    run = lambda *a: subprocess.run([sys.executable, "-m", *a], cwd=tmp_path, env=env,
                                    capture_output=True, text=True, timeout=180)
    # the config's own checkpoint path by default
    out = run("gaot_torch.tools.import_torch_ckpt", cfg_path, ref)
    assert out.returncode == 0, out.stderr
    assert "Imported" in out.stdout
    out = run("gaot_torch.tools.export_torch_ckpt", cfg_path)
    assert out.returncode == 0, out.stderr
    exported = torch.load(os.path.join(os.path.dirname(cfg["path"]["ckpt_path"]),
                                       "model.pt"), weights_only=True)
    _equal(exported["model"], sd)
