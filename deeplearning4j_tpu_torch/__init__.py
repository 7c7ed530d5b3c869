"""deeplearning4j_tpu_torch: the PyTorch/CUDA port of deeplearning4j_tpu.

The JAX package ``deeplearning4j_tpu`` is the reference; this package
mirrors its module paths and reads and writes the same config JSON and
checkpoint zip. It imports torch and numpy, never jax and nothing of
the JAX package. Entry points take ``device`` (default ``"cuda"``) and
raise without a card unless ``device="cpu"`` is passed.

Ported so far: the transformer LM's serving (``/v1/predict``), training
(``fit``) and generate (``/v1/generate``, streaming and paged-KV decode
sessions) paths, and the fleet of servers behind a router with
disaggregated prefill/decode and drain migration (``serving.fleet``,
``serving.router``), through hand-written CUDA kernels: the flash-attention
forward and backward (``csrc/flash_attention_{fwd,bwd}.cu``) and the
paged decode attention (``csrc/decode_attention.cu``); and the
convolutional networks: LeNet on ``MultiLayerNetwork`` and ResNet50 on
``ComputationGraph`` (``zoo``), trained, evaluated and served, in
float32 and under the bf16 policy (``dtypes.tpu_bf16()``), with conv,
pooling and GEMMs on cuDNN and cuBLAS; the recurrent family, Keras
import, and every layer type of the JAX package, with the whole model
zoo, layerwise ``pretrain`` and the transfer-learning builders
(``nn.transfer_learning``); the fleet's control loops (``serving.
autoscaler``, ``serving.rollout``, ``observability.fleetobs``) and
retrieval serving (``retrieval``: vector indexes and the text embedder
on the card, behind ``/v1/embed``, ``/v1/search`` and ``/v1/index``);
parallel training (the parameter server, data, tensor, sequence and
pipeline parallelism), the Word2Vec family, and the rest of the library
(layer-named errors, the gradient check, the second-order solvers, the
training UI, the estimators and the k-NN and streaming services): every
module of the JAX package but its jax version shims.
"""
