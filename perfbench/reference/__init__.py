"""Plain float32 PyTorch references of the families, one module each
(``perfbench/reference/<family>.py``), written from the published
architectures as the port builds them.  They import nothing of the
port: they take the benchmark's seeded weights and batches and work
everything else out themselves."""
