"""Leveled console logging with an env-var verbosity gate (the JAX
package's `utils/prompt_utils.py`).

Role-equivalent of the reference's prompt system
(MyoSuite's myosuite/utils/prompt_utils.py:19-89): messages carry a
type (INFO/WARN/ERROR/ONCE/ALWAYS) and print only when the configured
verbosity admits them. The env var is MTX_VERBOSITY (the reference reads
ROBOHIVE_VERBOSITY, prompt_utils.py:26); values: SILENT < ONCE < WARN <
INFO < ALWAYS/ALL.
"""

from __future__ import annotations

import enum
import os
import sys


class Prompt(enum.IntEnum):
  SILENT = 0
  ONCE = 1
  WARN = 2
  ERROR = 3
  INFO = 4
  ALWAYS = 5


_NAMES = {p.name: p for p in Prompt}
_NAMES["ALL"] = Prompt.ALWAYS
_ONCE_SEEN = set()

# Minimum verbosity required for each message type: ERROR/ALWAYS always
# print; WARN needs verbosity>=WARN; INFO needs verbosity>=INFO; ONCE
# prints at any non-silent verbosity (once).
_REQUIRED_VERBOSITY = {
    Prompt.ALWAYS: Prompt.SILENT,
    Prompt.ERROR: Prompt.SILENT,
    Prompt.WARN: Prompt.WARN,
    Prompt.INFO: Prompt.INFO,
    Prompt.ONCE: Prompt.ONCE,
}


def verbosity() -> Prompt:
  raw = os.environ.get("MTX_VERBOSITY",
                       os.environ.get("ROBOHIVE_VERBOSITY", "WARN")).upper()
  return _NAMES.get(raw, Prompt.WARN)


def prompt(message, type_: str = "INFO", flush: bool = False,
           end: str = "\n") -> None:
  """Print `message` if the current verbosity admits messages of `type_`."""
  level = _NAMES.get(type_.upper(), Prompt.INFO)
  if level == Prompt.ONCE:
    key = str(message)
    if key in _ONCE_SEEN:
      return
    _ONCE_SEEN.add(key)
  if verbosity() >= _REQUIRED_VERBOSITY[level]:
    stream = sys.stderr if level in (Prompt.WARN, Prompt.ERROR) else sys.stdout
    print(message, file=stream, flush=flush, end=end)
