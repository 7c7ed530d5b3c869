"""Import a Keras model and fine-tune it with transfer learning.

KerasModelImport -> freeze the feature extractor -> replace the head ->
fit. Builds a small Keras model on the fly, so it needs keras (and
h5py) installed; the port itself needs neither to run the imported
model.

Run: python -m deeplearning4j_tpu_torch.examples.keras_import_finetune
     [--device cuda|cpu]
"""

import argparse
import os
import tempfile

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--h5", default=None,
                    help="where to save the Keras model (default: a "
                         "temporary file)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    os.environ.setdefault("KERAS_BACKEND", "tensorflow")
    import keras
    from keras import layers

    from deeplearning4j_tpu_torch.data.fetchers import iris_data
    from deeplearning4j_tpu_torch.keras import (
        import_keras_model_and_weights)
    from deeplearning4j_tpu_torch.nn.conf import updaters
    from deeplearning4j_tpu_torch.nn.conf.layers import OutputLayer
    from deeplearning4j_tpu_torch.nn.transfer_learning import (
        FineTuneConfiguration, TransferLearning)

    with tempfile.TemporaryDirectory() as tmp:
        h5_path = args.h5 or os.path.join(tmp, "keras_base.h5")
        # 1. a "pretrained" Keras model
        km = keras.Sequential([
            keras.Input((4,)),
            layers.Dense(16, activation="relu"),
            layers.Dense(8, activation="relu"),
            layers.Dense(3, activation="softmax"),
        ])
        km.save(h5_path)

        # 2. import
        net = import_keras_model_and_weights(h5_path, device=args.device)
    print("imported:")
    print(net.summary())

    # 3. parity with Keras on the same inputs
    x = np.random.default_rng(0).normal(0, 1, (4, 4)).astype("float32")
    diff = np.abs(km.predict(x, verbose=0)
                  - net.output(x).cpu().numpy()).max()
    print(f"max |keras - ours| = {diff:.2e}")

    # 4. freeze the feature extractor, new head, fine-tune
    tuned = (TransferLearning.builder(net)
             .fine_tune_configuration(
                 FineTuneConfiguration(updater=updaters.adam(0.02)))
             .set_feature_extractor(1)
             .remove_output_layer()
             .add_layer(OutputLayer(n_out=3))
             .build())
    xs, ys = iris_data()
    tuned.fit(xs[:120], ys[:120], epochs=30, batch_size=32)
    acc = tuned.evaluate(xs[120:], ys[120:]).accuracy()
    print(f"fine-tuned accuracy: {acc:.3f}")
    return acc


if __name__ == "__main__":
    main()
