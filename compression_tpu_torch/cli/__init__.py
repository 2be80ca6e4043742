"""The tfci command line: model registry and verbs (counterpart of
``compression_tpu/cli/``)."""
