"""Data parallel across processes, one per GPU (counterpart of
``sessd_tpu/parallel``): ``mesh``."""
