"""The constants the gate's drop-box needs; values identical to
``tpu_operator/consts.py`` so the unchanged validator reads what the port
writes."""

VALIDATION_DIR = "/run/tpu/validations"
VALIDATION_ROOT_ENV = "TPU_VALIDATION_ROOT"  # test seam: relocate /run/tpu
