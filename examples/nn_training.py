"""Training a small neural network with the first-order suite.

The reference trains a perceptron with gradient descent (reference
tests/nn.cpp:277-282); this example trains a 2-layer MLP on a 1-D
regression task with every first-order solver — plain GD, SGD-momentum,
Adam — plus L-BFGS, which on small deterministic problems crushes all of
them.  Parameters are an arbitrary PYTREE (dict of weight matrices); the
tangent space is its flattening, no manual packing needed.

Run: python examples/nn_training.py  (CPU or GPU)
"""

import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if os.environ.get("TINYOPT_CPU"):
    # CI smoke lane: run on the CPU even where an accelerator exists
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

import tinyopt_tpu as to


HIDDEN = 16


def init_params(seed=0):
    rng = np.random.default_rng(seed)
    s = lambda *sh: jnp.asarray(rng.normal(0, 0.5, sh))
    return {"w1": s(HIDDEN, 1), "b1": s(HIDDEN),
            "w2": s(1, HIDDEN), "b2": s(1)}


def forward(p, x):
    h = jnp.tanh(p["w1"] @ x[None, :] + p["b1"][:, None])
    return (p["w2"] @ h + p["b2"][:, None])[0]


def main():
    rng = np.random.default_rng(1)
    x = jnp.asarray(np.linspace(-2, 2, 64))
    y = jnp.sin(2.0 * x) + 0.05 * jnp.asarray(rng.normal(size=64))

    def mse(p):
        return jnp.mean((forward(p, x) - y) ** 2)

    runs = [
        ("gd", to.gd, to.Options(max_iters=500, max_consec_failures=0,
                                 gd=to.GDOptions(lr=0.05))),
        ("sgd+momentum", to.sgd,
         to.Options(max_iters=500, max_consec_failures=0,
                    sgd=to.SGDOptions(lr=0.02, momentum=0.9))),
        ("adam", to.adam,
         to.Options(max_iters=500, max_consec_failures=0,
                    adam=to.AdamOptions(lr=0.05))),
        ("lbfgs", to.lbfgs,
         to.Options(max_iters=500, max_consec_failures=30,
                    lbfgs=to.LBFGSOptions(memory=10))),
    ]
    print(f"{'method':>14} {'final MSE':>12} {'iters':>6}  stop")
    for name, ns, opts in runs:
        p, out = ns.optimize(init_params(), mse, opts)
        print(f"{name:>14} {float(out.final_cost.cost):12.3e} "
              f"{int(out.num_iters):>6}  {out.stop_reason_description()}")


if __name__ == "__main__":
    main()
