"""The constants the gate's drop-box and the migratable jobs need; values
identical to ``tpu_operator/consts.py``, so the unchanged validator reads
what the port writes and the operator's migration drain reaches the port's
jobs."""

VALIDATION_DIR = "/run/tpu/validations"
VALIDATION_ROOT_ENV = "TPU_VALIDATION_ROOT"  # test seam: relocate /run/tpu

# migration contract (workloads/checkpoint.py, workloads/serving.py): the
# drain stamps this annotation on the pod, the job polls the downward-API
# annotations file for it (SIGTERM is the fallback), snapshots into the
# shared checkpoint directory and meshes over the declared topology
MIGRATE_ANNOTATION = "tpu.google.com/migrate"                # value: requested
MIGRATE_REQUESTED = "requested"
MIGRATE_SIGNAL_FILE_ENV = "TPU_MIGRATE_SIGNAL_FILE"
CKPT_DIR_ENV = "TPU_CKPT_DIR"
JOB_TOPOLOGY_ENV = "TPU_JOB_TOPOLOGY"
