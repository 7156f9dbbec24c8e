"""The bounded per-step phase vocabulary: own copy of the constants in
``tpu_operator/obs/profile.py`` (the only phase labels a step window may
carry; the operator's profile plane pins membership on the same names)."""

PHASE_COMPILE = "compile"
PHASE_HOST_INPUT = "host-input"
PHASE_COMPUTE = "compute"
PHASE_COLLECTIVE_WAIT = "collective-wait"

STEP_PHASES = (
    PHASE_COMPILE,
    PHASE_HOST_INPUT,
    PHASE_COMPUTE,
    PHASE_COLLECTIVE_WAIT,
)
