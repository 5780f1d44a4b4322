"""Config-as-code training recipes of the port (the JAX package's
models/iSegNet/*.py): each defines MODEL_NAME, init_model(cfg) and
main(cfg), and `python -m pvpuformer_tpu_torch.train <recipe>` runs it."""
