"""The port's sparse (BM25) side: numpy/scipy copies of ``mfar_tpu.sparse``."""
