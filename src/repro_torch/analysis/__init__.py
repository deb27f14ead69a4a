"""repro_torch.analysis — datapath bit-width certification.

An abstract interpreter over the port's own ``horner_body`` code object
(:mod:`.intervals`, an interval domain over scaled integers) proves, per
intermediate, the integer word length a table needs, and
:mod:`.certify` emits the machine-readable certificate the
``TableStore`` keeps next to the artifact.
"""

from .certify import (CERT_VERSION, Certificate, Violation, certify_config,
                      certify_table)
from .intervals import Interval, NodeBound, abstract_horner, node_fwls

__all__ = [
    "Interval",
    "NodeBound",
    "abstract_horner",
    "node_fwls",
    "CERT_VERSION",
    "Certificate",
    "Violation",
    "certify_config",
    "certify_table",
]
