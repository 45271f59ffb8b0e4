"""The benchmark harness of the PyTorch/CUDA port of the image codecs:
the cell runner (``harness``), what every traffic driver shares
(``drive``; the drivers themselves are ``drivers/<driver>.py``), the
seeded image banks (``bank``), the profiler reading (``trace``) and the
device timing of a call alone (``timing``)."""
