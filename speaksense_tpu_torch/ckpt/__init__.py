"""Checkpoint loading of the port: ggml (whisper.cpp format, every quant type
it ships), HuggingFace state dicts and directories, and the convert-once
on-disk cache. Each maps the weights into the JAX package's numpy parameter
pytree, which `models/whisper.py::params_from_jax` places on the device.
The port's own copy of `speaksense_tpu/ckpt/`.
"""
