"""Data-parallel ResNet50 over a mesh of ranks.

The BASELINE.json headline workload: zoo ResNet50 trained through the
ParallelWrapper, the batch sharded over the mesh's 'data' axis, each
rank's gradients all-reduced every step. One process a rank
(``examples/_ranks.py``): run with the multihost variables set, the
script is one rank; run without them, it starts 4 ranks of itself
(gloo on the CPU and when the ranks share a card, nccl with a card a
rank).

Run: python -m deeplearning4j_tpu_torch.examples.data_parallel_resnet
     [--img 64] [--steps 10] [--device cuda|cpu]
"""

import argparse
import sys

import numpy as np

from deeplearning4j_tpu_torch.examples import _ranks

WORLD = 4          # the ranks a launch starts


def train(img=64, batch_per_device=8, steps=10, n_classes=100,
          device="cuda"):
    """One rank's run: join the mesh, train, print (rank 0)."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.conf import updaters
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from deeplearning4j_tpu_torch.parallel.multihost import (
        initialize_distributed, process_count, process_index, rank_device)
    from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
    from deeplearning4j_tpu_torch.train.listeners import PerformanceListener
    from deeplearning4j_tpu_torch.zoo import ResNet50

    initialize_distributed(device=device)
    n_dev = process_count()
    lead = process_index() == 0
    mesh = build_mesh(MeshSpec(data=n_dev))
    if lead:
        print(f"{n_dev} devices, mesh {dict(mesh.shape)}", flush=True)

    net = ResNet50(n_classes=n_classes, input_shape=(img, img, 3),
                   updater=updaters.nesterovs(0.1, 0.9)).init(
        device=rank_device(device))
    rng = np.random.default_rng(0)
    batch = batch_per_device * n_dev
    x = rng.normal(0, 1, (batch, img, img, 3)).astype("float32")
    y = np.eye(n_classes, dtype="float32")[
        rng.integers(0, n_classes, batch)]

    net.set_listeners(PerformanceListener(frequency=2))
    pw = ParallelWrapper(net, mesh, prefetch_buffer=2)
    ds = DataSet(pw.local_shard(x), pw.local_shard(y))
    pw.fit(ListDataSetIterator([ds] * steps), epochs=1)
    if lead:
        print(f"final loss {float(net.score_value):.4f} after "
              f"{net.iteration_count} steps", flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--img", type=int, default=64)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if not _ranks.is_rank():
        return _ranks.launch(
            "deeplearning4j_tpu_torch.examples.data_parallel_resnet",
            sys.argv[1:] if argv is None else list(argv), WORLD,
            args.device)
    train(img=args.img, steps=args.steps, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
