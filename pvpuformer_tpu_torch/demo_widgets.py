"""Focus-aware Tk widget wrappers for the demo GUI (a copy of the
repository's demo_widgets.py for `python -m pvpuformer_tpu_torch.demo`).

Re-derivation of `interactive_demo/wrappers.py:5-92` (reference): plain Tk
widgets keep keyboard focus wherever it last was, so slider keystrokes land
on stale widgets and numeric entries are never validated; the reference
wraps every control so that (a) a mouse click moves focus to the clicked
control and (b) numeric entries are bounds-checked on focus loss, reverting
to the last valid value otherwise.

The validation core is a pure function (`validate_bounded`) so the policy
is testable headless (tests/test_torch_user_click.py); the Tk subclasses are
thin shims over it.
"""
from __future__ import annotations

from typing import Optional, Tuple


def validate_bounded(instr: str, vartype, min_value=None, max_value=None,
                     allow_inf: bool = False) -> Tuple[bool, Optional[object]]:
    """wrappers.py:30-55 `_check_bounds` policy as a pure function.

    Returns (accepted, parsed_value): accepted=False -> caller reverts to
    its previous value; parsed_value is the coerced in-bounds value (the
    string 'INF' when allow_inf accepts it).
    """
    if allow_inf and instr == "INF":
        return True, "INF"
    try:
        value = vartype(instr)
    except (ValueError, TypeError):
        return False, None
    if min_value is not None and value < min_value:
        return False, None
    if max_value is not None and value > max_value:
        return False, None
    return True, value


def _focus_on_click(widget) -> None:
    widget.bind("<1>", lambda event: widget.focus_set())


def make_widgets():
    """Build the wrapper classes lazily (importing tkinter only when a GUI
    actually starts — headless hosts have no display)."""
    import tkinter as tk
    from tkinter import messagebox, ttk

    class BoundedNumericalEntry(tk.Entry):
        """Numeric entry validated on focus loss (wrappers.py:5-55): an
        out-of-bounds or unparsable value reverts to the previous one and
        warns; a valid one is pushed to `variable`."""

        def __init__(self, master=None, min_value=None, max_value=None,
                     variable=None, vartype=float, width=7,
                     allow_inf=False, **kwargs):
            if variable is None:
                variable = (tk.DoubleVar() if vartype == float else
                            tk.IntVar() if vartype == int else tk.StringVar())
            self.var = variable
            self.fake_var = tk.StringVar(value=self.var.get())
            self.vartype = vartype
            self.old_value = self.var.get()
            self.allow_inf = allow_inf
            self.min_value, self.max_value = min_value, max_value
            vcmd = master.register(self._check_bounds)
            tk.Entry.__init__(self, master, textvariable=self.fake_var,
                              validate="focus", width=width,
                              vcmd=(vcmd, "%P", "%d"), **kwargs)

        def _check_bounds(self, instr, action_type):
            if action_type == "-1":          # focus in/out revalidation
                ok, value = validate_bounded(
                    instr, self.vartype, self.min_value, self.max_value,
                    self.allow_inf)
                if ok:
                    if value == "INF":
                        self.fake_var.set("INF")
                        return True
                    if value != self.old_value:
                        self.old_value = value
                        self.delete(0, tk.END)
                        self.insert(0, str(value))
                        self.var.set(value)
                    return True
                self.delete(0, tk.END)
                self.insert(0, str(self.old_value))
                mn = "-inf" if self.min_value is None else str(self.min_value)
                mx = "+inf" if self.max_value is None else str(self.max_value)
                messagebox.showwarning(
                    "Incorrect value in input field",
                    f"Value should be in [{mn}; {mx}] and of type "
                    f"{self.vartype.__name__}")
                return False
            return True

    class FocusHorizontalScale(tk.Scale):
        def __init__(self, *args, highlightthickness=0,
                     sliderrelief=tk.GROOVE, resolution=0.01,
                     sliderlength=20, length=200, **kwargs):
            tk.Scale.__init__(self, *args, orient=tk.HORIZONTAL,
                              highlightthickness=highlightthickness,
                              sliderrelief=sliderrelief,
                              resolution=resolution,
                              sliderlength=sliderlength, length=length,
                              **kwargs)
            _focus_on_click(self)

    class FocusCheckButton(tk.Checkbutton):
        def __init__(self, *args, highlightthickness=0, **kwargs):
            tk.Checkbutton.__init__(
                self, *args, highlightthickness=highlightthickness, **kwargs)
            _focus_on_click(self)

    class FocusButton(tk.Button):
        def __init__(self, *args, highlightthickness=0, **kwargs):
            tk.Button.__init__(
                self, *args, highlightthickness=highlightthickness, **kwargs)
            _focus_on_click(self)

    class FocusLabelFrame(ttk.LabelFrame):
        """Labeled group box that takes focus on click and can enable /
        disable all of its children at once (wrappers.py:80-92)."""

        def __init__(self, *args, relief=tk.RIDGE, borderwidth=2, **kwargs):
            tk.LabelFrame.__init__(self, *args, relief=relief,
                                   borderwidth=borderwidth, **kwargs)
            _focus_on_click(self)

        def set_frame_state(self, state):
            for w in self.winfo_children():
                w.configure(state=state)

    return {
        "BoundedNumericalEntry": BoundedNumericalEntry,
        "FocusHorizontalScale": FocusHorizontalScale,
        "FocusCheckButton": FocusCheckButton,
        "FocusButton": FocusButton,
        "FocusLabelFrame": FocusLabelFrame,
    }
