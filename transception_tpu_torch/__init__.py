"""PyTorch + CUDA port of transception_tpu: the serving path of the
published MSTransception on one NVIDIA H100 (see README.md)."""
