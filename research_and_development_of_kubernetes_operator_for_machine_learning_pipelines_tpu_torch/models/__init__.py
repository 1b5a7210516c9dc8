"""Llama, BERT, int8 quantization and sampling in PyTorch (port of the JAX
package's ``models/``)."""
