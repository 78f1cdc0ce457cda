"""Checks, one file each, found by the ``check`` name of a traffic file.
Each has ``judge(ses, item, judged, precision, share)``, the numbers
compared for one sampled fit: of the program's outputs in ``item``
(``judged="program"``), or of the reference solved and applied in
``precision`` in the program's place (``judged="reference"``; the control
with ``"tf32"``), over this rank's ``share`` of the checked sites; and
``work(shapes, t)``, the floating-point operations of the fit's Gram on
``t`` frames, which ``fit_mfu`` counts. Each check imports the references
it judges by from ``benchmark/reference/``."""
