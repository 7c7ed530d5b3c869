"""Runnable examples of the port, counterparts of the JAX package's
``examples/*.py``: each keeps that script's flags and the lines it
prints, takes ``--device`` (default ``cuda``; without a card only
``--device cpu`` runs), and imports only this package.

    python -m deeplearning4j_tpu_torch.examples.lenet_mnist --device cpu
    python -m deeplearning4j_tpu_torch.examples.streaming_generation
    python -m deeplearning4j_tpu_torch.examples.tpu_transformer_generate
    python -m deeplearning4j_tpu_torch.examples.elastic_transformer
    python -m deeplearning4j_tpu_torch.examples.word2vec_text
    python -m deeplearning4j_tpu_torch.examples.keras_import_finetune

Every ``main(argv=None)`` takes the command line's arguments as a list,
so a caller can run an example in its own process.
"""
