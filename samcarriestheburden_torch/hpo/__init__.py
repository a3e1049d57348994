"""Hyper-parameter optimisation of the refinement knobs (JAX ``hpo/``,
reference seg_processing/: Optuna grid and TPE studies), on the port's
refinement engine.  Self-contained optuna-compatible study and samplers; no
external dependency."""
