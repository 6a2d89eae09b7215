"""Examples of the PyTorch port (port of the repo's ``examples/``), each
run as ``python -m easyparallellibrary_tpu_torch.examples.<name>`` with
the JAX script's flags and printed lines, plus ``--device`` (default
the GPU; ``cpu`` to ask for the CPU):

* :mod:`train_gpt` — GPT with any parallelism mix the port supports;
* :mod:`generate_gpt` — autoregressive decoding with the KV cache;
* :mod:`train_bert_pipeline` — BERT pretraining on a 2-stage pipeline;
* :mod:`train_resnet_dp` — ResNet data-parallel, optionally with a
  split classifier head.

The JAX package drives every device from one process; the port runs one
process per rank.  An example whose mix needs several ranks starts them
itself (``utils.launcher.spawn``), or joins the group a launcher started
(``python -m easyparallellibrary_tpu_torch.utils.launcher --num_workers
N -- python -m ...``).  ``main(argv)`` returns rank 0's results.
"""
