"""Model zoo of the port: the GNN family (``gnn.py``) on ``common.py``'s
building blocks. Parameters are nested dicts and lists of leaf tensors, with
the JAX package's key names and layouts."""
