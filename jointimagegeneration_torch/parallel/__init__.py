"""The mesh's two axes: data parallelism over torch.distributed and the
single-controller (data, model) device grid (`mesh.py`), and the spatial
sharding of activations over the 'model' axis (`spatial.py`)."""
