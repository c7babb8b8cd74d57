"""The OOD split rule of ``jcf_tpu/infer/predict.py``: a prediction at or
below ``OOD_BOUNDARY_PRED`` is a base class (``ood.py:880``). The rest of
predict (the ensembles and result writers) is not ported yet."""

OOD_BOUNDARY_PRED = 372  # pred <= 372 -> base (ood.py:880)
