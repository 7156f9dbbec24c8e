"""The port's own copies of the node-side catalogues it needs."""
