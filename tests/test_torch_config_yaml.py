"""YAML configs: ``to_yaml`` / ``from_yaml`` of both configuration types
give the JAX package's text for the same configuration, and each package
reads the other's YAML back to the same JSON."""

import importlib

import pytest

import deeplearning4j_tpu as jpkg
import deeplearning4j_tpu_torch as tpkg


def _mods(pkg):
    get = lambda m: importlib.import_module(f"{pkg.__name__}.{m}")
    return (get("nn.conf.updaters"), get("nn.conf.inputs").InputType,
            get("nn.conf.layers"), get("nn.conf.graph"))


def lenet(pkg):
    updaters, InputType, L, _ = _mods(pkg)
    return (pkg.NeuralNetConfiguration.builder()
            .set_seed(12345)
            .updater(updaters.adam(1e-3))
            .weight_init("xavier")
            .list()
            .layer(L.ConvolutionLayer(n_out=20, kernel=(5, 5),
                                      activation="relu"))
            .layer(L.SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            .layer(L.ConvolutionLayer(n_out=50, kernel=(5, 5),
                                      activation="relu"))
            .layer(L.SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            .layer(L.DenseLayer(n_out=500, activation="relu", l2=1e-4,
                                dropout=0.2))
            .layer(L.OutputLayer(n_out=10, loss="mcxent"))
            .set_input_type(InputType.convolutional_flat(28, 28, 1))
            .build())


def graph(pkg):
    updaters, InputType, L, G = _mods(pkg)
    return (pkg.NeuralNetConfiguration.builder()
            .set_seed(7)
            .updater(updaters.nesterovs(0.1, 0.9))
            .graph_builder()
            .add_inputs("in")
            .add_layer("a", L.DenseLayer(n_out=8, activation="relu"), "in")
            .add_layer("b", L.DenseLayer(n_out=8, activation="tanh"), "in")
            .add_vertex("sum", G.ElementWiseVertex(op="add"), "a", "b")
            .add_vertex("cat", G.MergeVertex(), "a", "sum")
            .add_layer("out", L.OutputLayer(n_out=3), "cat")
            .set_outputs("out")
            .set_input_types(InputType.feed_forward(5))
            .build())


@pytest.mark.parametrize("build", [lenet, graph], ids=["lenet", "graph"])
def test_yaml_text_equal_and_read_both_ways(build):
    jconf, tconf = build(jpkg), build(tpkg)
    assert tconf.to_json() == jconf.to_json()
    jy, ty = jconf.to_yaml(), tconf.to_yaml()
    assert ty == jy
    tcls, jcls = type(tconf), type(jconf)
    assert tcls.from_yaml(jy).to_json() == jconf.to_json()
    assert jcls.from_yaml(ty).to_json() == tconf.to_json()
    assert tcls.from_yaml(ty).to_yaml() == ty
