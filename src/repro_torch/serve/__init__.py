"""Serving of the port: the batched greedy/temperature generation loop."""
