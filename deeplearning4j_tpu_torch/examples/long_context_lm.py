"""Sequence-parallel language-model training.

A causal transformer LM built from the config DSL trains over a mesh
whose `seq` axis shards the TIME dimension across ranks: the standard
``ParallelWrapper`` runs the model under the sequence-parallel context
and ``SelfAttentionLayer`` rides ring attention (exact global attention;
on a card every chunk goes through the flash kernels, here at head dim
4, padded to 32). The batch is VARIABLE-LENGTH: key-padding mask chunks
rotate around the ring with their K/V blocks, and the masked loss
divides by the global mask total. Training matches the single-device
step to float tolerance.

One process a rank (``examples/_ranks.py``): run with the multihost
variables set, the script is one rank of data=2 x seq=2; run without
them, it starts those 4 ranks of itself (gloo on the CPU and when the
ranks share a card, nccl with a card a rank).

Run: python -m deeplearning4j_tpu_torch.examples.long_context_lm
     [--epochs 20] [--device cuda|cpu]
"""

import argparse
import sys

import numpy as np

from deeplearning4j_tpu_torch.examples import _ranks

VOCAB, T, B = 11, 32, 8
WORLD = 4          # data=2 x seq=2


def make_net(seed=3, device="cpu"):
    from deeplearning4j_tpu_torch import (MultiLayerNetwork,
                                          NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf import InputType, updaters
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        EmbeddingSequenceLayer, RnnOutputLayer, TransformerEncoderLayer)
    conf = (NeuralNetConfiguration.builder().set_seed(seed)
            .updater(updaters.adam(1e-2)).list()
            .layer(EmbeddingSequenceLayer(n_in=VOCAB, n_out=16))
            .layer(TransformerEncoderLayer(n_heads=4, causal=True))
            .layer(TransformerEncoderLayer(n_heads=4, causal=True))
            .layer(RnnOutputLayer(n_out=VOCAB, loss="mcxent"))
            .set_input_type(InputType.recurrent(VOCAB, T)).build())
    return MultiLayerNetwork(conf, device=device).init()


def make_data(seed=0):
    """Cyclic-successor LM: token[t+1] = (token[t] + k) mod V with a
    per-sequence stride k the model must infer from context — causal
    attention's bread and butter. Sequences are RAGGED (variable
    length), exercising the rotating mask chunks."""
    rng = np.random.default_rng(seed)
    toks = np.zeros((B, T), np.int64)
    for b in range(B):
        k = rng.integers(1, 4)
        toks[b, 0] = rng.integers(0, VOCAB)
        for t in range(1, T):
            toks[b, t] = (toks[b, t - 1] + k) % VOCAB
    x = toks.astype("float32")           # int ids -> embedding layer
    y = np.eye(VOCAB, dtype="float32")[np.roll(toks, -1, axis=1)]
    mask = np.ones((B, T), np.float32)
    lengths = rng.integers(T // 2, T, B)   # ragged, < T: the final
    for b in range(B):                     # position never has a
        mask[b, lengths[b]:] = 0.0         # next-token target anyway
    return x, y, mask


def train(epochs, device="cuda"):
    """One rank's run over data=2 x seq=2. Returns the exit status: 1
    on rank 0 when the run does not match the single-device run or the
    loss did not fall, else 0."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from deeplearning4j_tpu_torch.parallel.multihost import (
        initialize_distributed, process_count, process_index, rank_device)
    from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper

    initialize_distributed(device=device)
    if process_count() < 4:
        raise SystemExit("needs 4 ranks (data=2 x seq=2)")
    dev = rank_device(device)
    lead = process_index() == 0
    x, y, mask = make_data()
    mesh = build_mesh(MeshSpec(data=2, seq=2))
    if lead:
        print(f"mesh: data=2 x seq=2 over {mesh.size} devices — "
              f"T={T} sharded 2-way, ragged lengths "
              f"{[int(mask[b].sum()) for b in range(B)]}", flush=True)

    net = make_net(device=dev)
    pw = ParallelWrapper(net, mesh, prefetch_buffer=0)
    loc = pw.local_shard
    ds = DataSet(loc(x), loc(y), loc(mask), loc(mask))
    pw.fit(ListDataSetIterator([ds]), epochs=1)
    first = float(net.score_value)
    pw.fit(ListDataSetIterator([ds]), epochs=epochs - 1)
    last = float(net.score_value)
    status = 0
    if lead:
        print(f"seq-parallel masked LM loss: {first:.3f} -> {last:.3f}",
              flush=True)
        # the headline property: identical to the single-device step
        single = make_net(device=dev)
        full = DataSet(x, y, mask, mask)
        for _ in range(epochs):
            single.fit(full)
        same = np.allclose(net.params_flat(), single.params_flat(),
                           rtol=2e-4, atol=2e-5)
        print(f"matches single-device params: {same}", flush=True)
        status = 0 if same and last < first else 1
    dist.barrier()
    dist.destroy_process_group()
    return status


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not _ranks.is_rank():
        return _ranks.launch(
            "deeplearning4j_tpu_torch.examples.long_context_lm",
            sys.argv[1:] if argv is None else list(argv), WORLD,
            args.device)
    return train(max(2, args.epochs), args.device)   # >= 2: loss moves


if __name__ == "__main__":
    sys.exit(main())
