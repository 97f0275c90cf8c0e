"""The plain reference that decides whether a benchmark run is correct.

Plain PyTorch, f32 unless a control asks for less, on whatever device the
caller's tensors live. It imports nothing of the program under test: it
parses the Darknet cfg itself (``darknet.build``), runs the detector from
the weights the harness made (``darknet.forward``; float, train mode, and
the google and cos-PTQ fake-quant schemes with their calibration), decodes
and suppresses (``detect``), and scores a training batch (``loss``).
"""
