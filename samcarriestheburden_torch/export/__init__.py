"""Model export: the decoder program through ``torch.export`` and as an ONNX
graph (JAX ``export/``)."""
