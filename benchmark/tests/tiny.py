"""A small configuration of each layout, for running the harness on the CPU."""
import copy

TRAIN = {"mode": "train"}
INFER = {"mode": "infer", "request_samples": 8, "pool_requests": 3, "sample_every": 2}
LIMITS_TRAIN = {"loss_gap": 1e-5, "step_loss_gap": 1e-5, "grad_gap": 1e-4, "update_gap": 1e-3}
LIMITS_INFER = {"pred_gap": 1e-4}

_MODEL = {
    "name": "gaot",
    "latent_tokens_size": [8, 8],
    "args": {
        "magno": {"coord_dim": 2, "radius": 0.3, "hidden_size": 16, "mlp_layers": 2,
                  "lifting_channels": 8},
        "transformer": {"patch_size": 2, "hidden_size": 32, "num_layers": 3,
                        "attn_config": {"num_heads": 4, "num_kv_heads": 4}},
    },
}
_OPT = {"name": "adamw", "args": {"lr": 8e-4, "weight_decay": 1e-05, "epoch": 100,
                                  "eval_every_eps": 2, "scheduler": "mix",
                                  "max_lr": 1e-3, "min_lr": 1e-4, "final_lr": 5e-5}}

FX = {
    "name": "tiny_fx", "dtype": "float32",
    "data": {"layout": "fx_poisson", "nodes": 96, "domain": [[0, 0], [1, 1]]},
    "config": {
        "setup": {"seed": 42, "trainer_name": "static", "train": True},
        "model": _MODEL,
        "dataset": {"name": "Poisson-Gauss", "metaname": "elliptic_pdes/Poisson-Gauss",
                    "train_size": 16, "val_size": 8, "test_size": 8, "batch_size": 4,
                    "shuffle": True},
        "optimizer": _OPT,
    },
}

VX = copy.deepcopy(FX)
VX.update(name="tiny_vx",
          data={"layout": "vx_naca", "nodes": 128, "domain": [[-1, -1.5], [2.5, 2]]})
VX["config"]["dataset"].update(name="naca0012", metaname="compressible_flow/naca0012")
VX["config"]["model"]["args"]["magno"].update(sampling_strategy="max_neighbors",
                                              max_neighbors=4, radius=0.35)

# Edge drop to more neighbours than the decoder's queries have: only the
# encoder's edges are drawn (naca0012's case).
VX_CAPPED = copy.deepcopy(VX)
VX_CAPPED.update(name="tiny_vx_capped")
VX_CAPPED["config"]["model"]["args"]["magno"].update(max_neighbors=8)


def cell(name, config, traffic):
    return {"workloads": [{"name": name, "config": config, "traffic": traffic, "chips": 1,
                           "why": "test"}],
            "end_to_end": [{"name": "train_samples_per_s", "unit": "samples/s"},
                           {"name": "infer_samples_per_s", "unit": "samples/s"},
                           {"name": "infer_ms_p95", "unit": "ms"},
                           {"name": "setup_s", "unit": "s"}],
            "per_layer": []}
