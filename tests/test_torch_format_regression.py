"""The committed v1 checkpoint fixtures, on the port.

``tests/fixtures/mln_v1.zip`` and ``cg_v1.zip`` carry the zip format's
backward-compatibility contract (``tests/test_format_regression.py``
holds it for the JAX package): the port must load them and compute the
outputs of ``*_io.npz`` from their weights (rtol 1e-5, atol 1e-6), and
resume training from them. The fixtures are read, never regenerated.
"""

import os

import numpy as np

from deeplearning4j_tpu_torch.util.model_serializer import restore_model

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


class TestV1Format:
    def test_mln_v1_loads_and_reproduces_outputs(self):
        net = restore_model(os.path.join(FIXTURES, "mln_v1.zip"),
                            device="cpu")
        io = np.load(os.path.join(FIXTURES, "mln_v1_io.npz"))
        out = net.output(io["x"]).numpy()
        np.testing.assert_allclose(out, io["out"], rtol=1e-5, atol=1e-6)
        names = [type(l).__name__ for l in net.layers]
        assert names == ["ConvolutionLayer", "SubsamplingLayer",
                         "BatchNormalization", "DenseLayer",
                         "OutputLayer"]
        assert net.layers[3].l2 == 1e-4
        assert net.layers[3].dropout == 0.2

    def test_mln_v1_resumes_training(self):
        net = restore_model(os.path.join(FIXTURES, "mln_v1.zip"),
                            device="cpu")
        io = np.load(os.path.join(FIXTURES, "mln_v1_io.npz"))
        y = np.eye(3, dtype="float32")[[0, 1, 2]]
        before = net.iteration_count
        net.fit(io["x"], y, epochs=1)
        assert net.iteration_count == before + 1
        assert np.isfinite(float(net.score_value))

    def test_cg_v1_loads_and_reproduces_outputs(self):
        cg = restore_model(os.path.join(FIXTURES, "cg_v1.zip"),
                           device="cpu")
        io = np.load(os.path.join(FIXTURES, "cg_v1_io.npz"))
        out = cg.output(io["x"])
        out = (out[0] if isinstance(out, (list, tuple)) else out).numpy()
        np.testing.assert_allclose(out, io["out"], rtol=1e-5, atol=1e-6)
        assert "cat" in cg.conf.vertices
