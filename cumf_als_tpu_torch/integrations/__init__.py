"""Framework surfaces of the port: the DoAls op for PyTorch (torch_op)
and TensorFlow (tf_op, optional)."""
