"""LeNet on MNIST: the framework's hello-world.

Config DSL -> MultiLayerNetwork -> fit with listeners -> evaluate ->
checkpoint -> reload. Uses MNIST if cached locally (the fetchers'
cache), a deterministic synthetic surrogate otherwise; nothing is
downloaded.

Run: python -m deeplearning4j_tpu_torch.examples.lenet_mnist
     [--epochs 3] [--batch 128] [--device cuda|cpu]
"""

import argparse
import os
import tempfile

from deeplearning4j_tpu_torch import MultiLayerNetwork, NeuralNetConfiguration
from deeplearning4j_tpu_torch.data.fetchers import MnistDataSetIterator
from deeplearning4j_tpu_torch.data.iterators import AsyncDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import InputType, updaters
from deeplearning4j_tpu_torch.nn.conf.layers import (ConvolutionLayer,
                                                     DenseLayer, OutputLayer,
                                                     SubsamplingLayer)
from deeplearning4j_tpu_torch.train import (PerformanceListener,
                                            ScoreIterationListener)
from deeplearning4j_tpu_torch.util.model_serializer import (restore_model,
                                                            write_model)


def lenet_conf():
    return (NeuralNetConfiguration.builder()
            .set_seed(12345)
            .updater(updaters.adam(2e-3))
            .list()
            .layer(ConvolutionLayer(n_out=20, kernel=(5, 5),
                                    activation="relu"))
            .layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=50, kernel=(5, 5),
                                    activation="relu"))
            .layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            .layer(DenseLayer(n_out=500, activation="relu"))
            .layer(OutputLayer(n_out=10, loss="mcxent"))
            .set_input_type(InputType.convolutional_flat(28, 28, 1))
            .build())


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--n-train", type=int, default=4096)
    p.add_argument("--out", default=None,
                   help="checkpoint zip (default: a temporary file)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    net = MultiLayerNetwork(lenet_conf(), device=args.device).init()
    print(net.summary())
    net.set_listeners(ScoreIterationListener(10),
                      PerformanceListener(frequency=10))

    train = AsyncDataSetIterator(
        MnistDataSetIterator(args.batch, train=True, n=args.n_train))
    test = MnistDataSetIterator(256, train=False, n=1024, shuffle=False)

    net.fit(train, epochs=args.epochs)
    ev = net.evaluate(test)
    print(ev.stats())

    with tempfile.TemporaryDirectory() as tmp:
        out = args.out or os.path.join(tmp, "lenet.zip")
        write_model(net, out)
        reloaded = restore_model(out, device=args.device)
        print(f"checkpoint round trip OK: "
              f"{reloaded.evaluate(test).accuracy():.4f} accuracy")
    return ev.accuracy()


if __name__ == "__main__":
    main()
