"""The node agents that face the cards: feature discovery, the metrics agent
and exporter, and the node-status exporter (port of
``tpu_operator/agents``; the operand DaemonSets run each with ``python -m
tpu_operator_torch.agents.<name>``)."""
