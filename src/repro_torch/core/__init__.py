"""Core of the NAS loop (counterpart of ``repro/core``): the port's own
copies of the reference's numpy modules, and the trainer and the model
compiler in PyTorch."""
