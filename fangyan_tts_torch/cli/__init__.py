"""Command-line entry points of the port, flag-compatible with the JAX
package's (fangyan_tts_tpu/cli/) and with the reference's top-level
scripts: the data-prep stages 0-4 so far. The extraction CLIs take
--device (CUDA by default)."""
