#!/usr/bin/env python3
"""The char-RNN learning run of ``chip_smoke.py`` on the JAX package.

    JAX_PLATFORMS=cpu python3 rnn_learn_reference.py [--symbols 80 20]
                                                     [--seeds 0 1 2 3]

The reference for what ``chip_smoke.rnn_phase`` asserts of the port:
the bench leg's char-RNN (``bench.py:381-418``: B=32, T=64, vocab 80,
two GravesLSTM(256), RMSProp 1e-3) built with the JAX package, trained
CHAR_LEARN_STEPS steps on ``chip_smoke.learn_data``'s text (the same
text, held-out windows and window offsets as the smoke draws), with
init seed and data seed both ``seed``. For each (symbols, seed) it
prints the first and last step's loss and the next-symbol accuracy on
the held-out windows. It asserts nothing about the numbers.

It imports the JAX package and, of ``chip_smoke``, only its constants
and its numpy data helpers (that module imports nothing but the
standard library when it is imported).
"""

import argparse
import time

import numpy as np

import chip_smoke as smoke
from chip_smoke import CHAR_B, CHAR_H, CHAR_LEARN_STEPS, CHAR_T, CHAR_V


def char_rnn(seed):
    from deeplearning4j_tpu import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf import updaters
    from deeplearning4j_tpu.nn.conf.inputs import InputType
    from deeplearning4j_tpu.nn.conf.layers import GravesLSTM, RnnOutputLayer
    conf = (NeuralNetConfiguration.builder().set_seed(0)
            .updater(updaters.rmsprop(1e-3)).list()
            .layer(GravesLSTM(n_out=CHAR_H, activation="tanh"))
            .layer(GravesLSTM(n_out=CHAR_H, activation="tanh"))
            .layer(RnnOutputLayer(n_out=CHAR_V, loss="mcxent"))
            .set_input_type(InputType.recurrent(CHAR_V, CHAR_T)).build())
    return MultiLayerNetwork(conf).init(seed=seed)


def one_hot(ids):
    oh = np.eye(CHAR_V, dtype="float32")[ids]
    return oh[:, :-1], oh[:, 1:]


def learn(symbols, seed):
    from deeplearning4j_tpu.data.dataset import DataSet
    net = char_rnn(seed)
    text, held, rng = smoke.learn_data(symbols, seed)
    span = len(text) - CHAR_T - 1
    hx, hy = one_hot(smoke.windows(text, held))

    def accuracy():
        out = np.asarray(net.output(hx))
        return float((out.argmax(-1) == hy.argmax(-1)).mean())
    losses = []
    t0 = time.perf_counter()
    for k in range(CHAR_LEARN_STEPS):
        net.fit(DataSet(*one_hot(
            smoke.windows(text, rng.integers(0, span, CHAR_B)))))
        if k in (0, CHAR_LEARN_STEPS - 1):
            losses.append(float(net.score_value))
    acc = accuracy()
    print(f"JAX package, {symbols} symbols, seed {seed}: {CHAR_LEARN_STEPS} "
          f"steps in {time.perf_counter() - t0:.1f} s; loss "
          f"{losses[0]:.4f} at step 1, {losses[1]:.4f} at step "
          f"{CHAR_LEARN_STEPS}; held-out next-symbol accuracy {acc:.4f}",
          flush=True)
    return acc


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--symbols", type=int, nargs="+",
                    default=[CHAR_V, smoke.LEARN_SYMBOLS])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = ap.parse_args()
    import jax
    print(f"jax {jax.__version__} on {jax.devices()[0].platform}",
          flush=True)
    for symbols in args.symbols:
        accs = [learn(symbols, seed) for seed in args.seeds]
        print(f"{symbols} symbols: accuracy {min(accs):.4f}-{max(accs):.4f} "
              f"over seeds {args.seeds}", flush=True)


if __name__ == "__main__":
    main()
