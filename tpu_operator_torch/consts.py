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

# ---------------------------------------------------------------------------
# The node validator (validator/components.py, validator/cli.py): the
# reference's values, so the operator's init-container chain, the status
# exporter and the DaemonSet templates read what the port's validator
# writes.  The names keep their TPU wording where the content is the card's.
OPERATOR_NAMESPACE_ENV = "OPERATOR_NAMESPACE"
LOG_FORMAT_ENV = "TPU_OPERATOR_LOG_FORMAT"
# one root knob: every node-local dir below derives from it
RUN_TPU_DIR = VALIDATION_DIR.rsplit("/", 1)[0]
# the kernel-library artifact store's parent (workload pods mount exactly it)
COMPILE_CACHE_DIR = RUN_TPU_DIR + "/compile_cache"
# the measured-results drop-box: its own subdir, so workload pods are
# mounted only the cache and the results, never the ready markers
WORKLOAD_RESULTS_DIR = RUN_TPU_DIR + "/workload-results"
STATUS_FILES = {
    "libtpu": "libtpu-ready",
    "pjrt": "pjrt-ready",
    "plugin": "plugin-ready",
    "jax": "jax-ready",
    # post-ready perf probes (report-only: readiness never gates on perf)
    "perf": "perf-ready",
    "runtime-prep": "runtime-prep-ready",
}
VALIDATOR_SLEEP_SECONDS = 5.0
VALIDATOR_WORKLOAD_RETRIES = 60
VALIDATOR_RESOURCE_RETRIES = 30
# the runtime container's handoff marker (the driver container's here)
LIBTPU_CTR_MARKER = ".libtpu-ctr-ready"
EVENT_TRACE_ID_ANNOTATION = "tpu.google.com/trace-id"

# The extended resource NVIDIA's device plugin advertises, and the card
# label its feature discovery sets (e.g. NVIDIA-H100-80GB-HBM3): the port's
# counterparts of google.com/tpu and the GKE accelerator label.
GPU_RESOURCE = "nvidia.com/gpu"
GPU_PRODUCT_LABEL = "nvidia.com/gpu.product"

# A multi-host slice keeps the reference's identity, so the unchanged
# operator's slice scheduler, its slice readiness labels and feature
# discovery name the same slices: the GKE nodepool, topology and
# accelerator labels, the host's worker id (feature discovery's label, else
# GKE's), the multislice group a deployment declares with its slice count,
# and the runtime version label a validation epoch hashes.
GKE_TPU_ACCELERATOR_LABEL = "cloud.google.com/gke-tpu-accelerator"
GKE_TPU_TOPOLOGY_LABEL = "cloud.google.com/gke-tpu-topology"
GKE_NODEPOOL_LABEL = "cloud.google.com/gke-nodepool"
GKE_TPU_WORKER_ID_LABEL = "cloud.google.com/gke-tpu-worker-id"
TFD_SLICE_WORKER_ID_LABEL = "tpu.google.com/tpu.slice.worker-id"
TFD_RUNTIME_VERSION_LABEL = "tpu.google.com/tpu.runtime.version"
MULTISLICE_GROUP_LABEL = "tpu.google.com/multislice-group"
MULTISLICE_SLICES_LABEL = "tpu.google.com/multislice-slices"

# ---------------------------------------------------------------------------
# The node agents (deviceplugin/, agents/, validator/metrics.py): the
# reference's label, annotation, env and size values, so the unchanged
# operator's health engine, slice scheduler and fleet ingest read what the
# port's agents publish.
TFD_CHIP_LABEL = "tpu.google.com/tpu.chip"                  # the card's generation
TFD_CHIPS_PER_HOST_LABEL = "tpu.google.com/tpu.chips-per-host"
TFD_HBM_GB_LABEL = "tpu.google.com/tpu.memory.hbm-gb"
TFD_ICI_TOPOLOGY_LABEL = "tpu.google.com/tpu.ici.topology"
TFD_SLICE_HOSTS_LABEL = "tpu.google.com/tpu.slice.hosts"
TPU_HEALTH_LABEL = "tpu.google.com/tpu-health"              # ok | unhealthy
TPU_HEALTH_REASON_ANNOTATION = "tpu.google.com/tpu-health-reason"
HEALTH_OK = "ok"
HEALTH_UNHEALTHY = "unhealthy"
FLEET_PUSH_ENV = "TPU_FLEET_PUSH_URL"   # the metrics agent forwards /push traffic here
PUSH_MAX_BYTES = 256 * 1024             # the agent's /push body cap

# ---------------------------------------------------------------------------
# Partitions of whole cards and the operand agents (agents/slice_manager.py,
# deviceplugin/sliceconfig.py, agents/runtime_manager.py,
# agents/config_manager.py): the reference's labels and annotation, so the
# unchanged operator's policy sets what the port's agents read.
TPU_COUNT_LABEL = "tpu.google.com/tpu.count"                # cards a host holds
SLICE_CONFIG_LABEL = "google.com/tpu.slice.config"          # the profile's name
SLICE_CONFIG_STATE_LABEL = "google.com/tpu.slice.config.state"  # pending|success|failed
UPGRADE_REQUESTED_ANNOTATION = "tpu.google.com/tpu-runtime-upgrade-requested"
DEVICE_PLUGIN_CONFIG_LABEL = "tpu.google.com/device-plugin.config"
