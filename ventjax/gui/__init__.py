"""Desktop GUI for ventjax — controller (headless, testable) + tkinter view.

The reference ships a PySimpleGUI desktop app wrapping the whole pipeline
(/root/reference/Vent_Analysis.py:607-1013).  ventjax splits that app in
two so the event-loop logic is unit-testable on a headless server:

  * :mod:`ventjax.gui.controller` — every GUI event as a plain method over
    an explicit :class:`GuiState`; no toolkit import anywhere.
  * :mod:`ventjax.gui.app` — a thin tkinter view binding widgets to the
    controller (tkinter ships with CPython; PySimpleGUI is not a dep).

Launch with ``python -m ventjax gui``.
"""
from ventjax.gui.controller import GuiState, Status, VentController

__all__ = ["GuiState", "Status", "VentController"]
