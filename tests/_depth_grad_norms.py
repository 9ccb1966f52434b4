"""How the first train step's gradient norm grows with depth at a frames
arch's published width, in the reference and in the port, from the same
weights (``interop.lm_from_reference``) and the same batch: float32,
remat off, vocab cut to 2,048, 4 x 32 seeded frames, one
``make_train_step`` each. Prints one line a case:

    PYTHONPATH=src python tests/_depth_grad_norms.py [ARCH ...]

Not collected by pytest (no ``test_`` prefix); takes a few minutes on the
CPU at 12 layers.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import optim as ref_optim
from repro.configs import get_config as ref_get_config
from repro.models import init_lm as ref_init_lm
from repro.parallel.sharding import Rules as RefRules
from repro.training import Hyper as RefHyper
from repro.training import make_train_step as ref_make_train_step
from repro_torch.configs import get_config
from repro_torch.interop import lm_from_reference
from repro_torch.optim import init_opt_state
from repro_torch.parallel.sharding import Rules
from repro_torch.training import Hyper, make_train_step

DEPTHS = (1, 4, 12)
HYPER = dict(lr=1e-3, warmup=5, total_steps=4)


def case(arch: str, n_layers: int):
    cut = dict(n_layers=n_layers, vocab_size=2048, param_dtype="float32",
               compute_dtype="float32", remat="none")
    ref_cfg = ref_get_config(arch).replace(**cut)
    cfg = get_config(arch).replace(**cut)
    rng = np.random.default_rng(0)
    batch = {"frames": rng.normal(size=(4, 32, cfg.d_model)).astype(
                 np.float32),
             "labels": rng.integers(0, 2048, (4, 32)).astype(np.int32)}
    params, _ = ref_init_lm(ref_cfg, jax.random.PRNGKey(0))
    step = jax.jit(ref_make_train_step(ref_cfg, RefRules(),
                                       RefHyper(**HYPER)))
    _, _, want = step(params, ref_optim.init_opt_state(params),
                      jax.tree.map(jnp.asarray, batch), jnp.int32(0))
    lm = lm_from_reference(cfg, jax.tree.map(np.asarray, params),
                           device="cpu")
    _, _, got = make_train_step(cfg, Rules(), Hyper(**HYPER))(
        lm, init_opt_state(lm),
        {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    print(f"{arch} layers {n_layers}: loss reference "
          f"{float(want['loss']):.6f} port {float(got['loss']):.6f}; "
          f"grad norm reference {float(want['grad_norm']):.6g} port "
          f"{float(got['grad_norm']):.6g}", flush=True)


if __name__ == "__main__":
    for arch in sys.argv[1:] or ("qwen2-vl-2b", "musicgen-large"):
        for n in DEPTHS:
            case(arch, n)
