"""The node agents (port of ``tpu_operator/agents``; the operand DaemonSets
run each with ``python -m tpu_operator_torch.agents.<name>``): those that
face the cards (feature discovery, the metrics agent and exporter, the
node-status exporter), the slice manager, and the operand agents (the
runtime manager, the vfio manager, the config manager, runtime prep, the
runtime container's marker, the VM runtime manager)."""
