"""Preemption-safe transformer training, end to end.

A small transformer classifier (SelfAttentionLayer, head dim 4: on a
card the flash-attention forward and backward kernels at their padded
width) trained under :class:`ElasticTrainer`: atomic checkpoints carry
the DATA POSITION, so killing the run at any batch and re-running the
same command reproduces the uninterrupted run bit for bit.

Run: python -m deeplearning4j_tpu_torch.examples.elastic_transformer
     [--epochs 4] [--device cuda|cpu]
"""

import argparse
import os
import shutil
import tempfile

import numpy as np


def make_net(device, seed=7):
    from deeplearning4j_tpu_torch import (MultiLayerNetwork,
                                          NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf import InputType, updaters
    from deeplearning4j_tpu_torch.nn.conf.layers import (GlobalPoolingLayer,
                                                         OutputLayer,
                                                         SelfAttentionLayer)
    conf = (NeuralNetConfiguration.builder().set_seed(seed)
            .updater(updaters.adam(5e-3)).list()
            .layer(SelfAttentionLayer(n_out=16, n_heads=4))
            .layer(GlobalPoolingLayer(pooling="max"))
            .layer(OutputLayer(n_out=3))
            .set_input_type(InputType.recurrent(8, 12)).build())
    return MultiLayerNetwork(conf, device=device).init()


def make_data(n=384, t=12, f=8, seed=0):
    """Marker-retrieval task: the class is which of 3 marker vectors
    appears at a random position: attention's home turf."""
    rng = np.random.default_rng(seed)
    markers = rng.normal(0, 3.0, (3, f)).astype(np.float32)
    xs = rng.normal(0, 0.5, (n, t, f)).astype(np.float32)
    labels = rng.integers(0, 3, n)
    xs[np.arange(n), rng.integers(0, t, n)] = markers[labels]
    ys = np.eye(3, dtype=np.float32)[labels]
    return xs, ys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.train.fault_tolerance import ElasticTrainer

    xs, ys = make_data()
    batches = DataSet(xs[:320], ys[:320]).batch_by(64)   # 5/epoch

    ckdir = tempfile.mkdtemp(prefix="elastic_")
    try:
        # --- run A: uninterrupted ---
        netA = make_net(args.device)
        ElasticTrainer(netA, os.path.join(ckdir, "a"),
                       save_every=1000).fit(batches,
                                            until_epoch=args.epochs)

        # --- run B: killed mid-epoch (a simulated preemption), then the
        # SAME command re-run: it resumes from the checkpointed data
        # position and finishes identically ---
        netB = make_net(args.device)
        tB = ElasticTrainer(netB, os.path.join(ckdir, "b"),
                            save_every=1000)

        class KillAt:
            def __init__(self, inner, at):
                self.inner, self.at, self.n = inner, at, 0

            def reset(self):
                pass

            def __iter__(self):
                for b in self.inner:
                    yield b
                    self.n += 1
                    if self.n == self.at:
                        tB._stop_requested = True   # the SIGTERM analog

        tB.fit(KillAt(batches, 7), until_epoch=args.epochs)
        print(f"killed at iteration {netB.iteration_count} "
              f"(epoch {tB._epoch}, batch {tB._batch})")

        netB2 = make_net(args.device)
        ElasticTrainer(netB2, os.path.join(ckdir, "b")).fit(
            batches, until_epoch=args.epochs)     # same command again

        same = np.array_equal(np.asarray(netA.params_flat()),
                              np.asarray(netB2.params_flat()))
        print("restart == uninterrupted:", "OK" if same else "MISMATCH")
        assert same

        acc = netB2.evaluate(xs[320:], ys[320:]).accuracy()
        print(f"Accuracy after resume: {acc:.3f}")
        assert acc > 0.8 or args.epochs < 4   # 4 epochs converge
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


if __name__ == "__main__":
    main()
