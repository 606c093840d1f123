"""The port's editor view-model and Qt GUI.

The view-model over a session of the small generator of
tests/test_torch_explore_helpers.py (f32, CEM, LR 16 x 16, on the CPU): the
pointer protocol of the three selection modes, rendering (canvas, selection
outline, rubber band, Z map: the same pixels as the JAX view-model's for
the same Z), the SR cache, the text mask's contract (the port's own 5 x 7
bitmap font: a deliberate divergence from PIL's glyphs), the imprint tools
(CEM-consistent), the alternatives picker, progress events, the search
controls and session io. The GUI is driven through the same fake Qt binding
that tests/test_gui_stub.py injects: against a spy view-model (every action,
dialog and pointer event) and against the real view-model.
"""

import numpy as np
import pytest
import torch

from esr_tpu.explore import EditorViewModel as JViewModel
from esr_tpu.explore.session import ExplorationSession as JSession
from esr_tpu_torch.explore import gui
from esr_tpu_torch.explore.session import ExplorationSession
from esr_tpu_torch.explore.viewmodel import EditorViewModel, _mask_boundary, _text_bitmap, render_text_mask
from test_gui_stub import _Dialog, _FileDialog, _InputDialog, _install_fake_qt, _MainWindow, _PushButton, _SpyVM
from test_torch_explore_helpers import Setup

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    return Setup()


def make_vm(setup, n_steps=2):
    return EditorViewModel(ExplorationSession(setup.g(), setup.cem, setup.lr, n_steps=n_steps))


def _residual(setup, sr) -> float:
    return float((setup.cem.downsample(torch.from_numpy(sr)) - torch.from_numpy(setup.lr)).abs().max())


def test_rect_polygon_brush_selection(setup):
    vm = make_vm(setup)
    vm.pointer_down(8, 8)
    vm.pointer_drag(30, 40)
    vm.pointer_up(31, 47)
    assert vm.selection_mask[8:32, 8:48].all() and vm.selection_mask.sum() == 24 * 40
    vm.pointer_down(50, 60)
    vm.pointer_up(40, 43)  # any drag direction
    assert vm.selection_mask[40:51, 43:61].all()
    vm.set_selection_mode("polygon")
    assert "at least" in vm.finish_polygon()
    for y, x in [(8, 8), (8, 40), (40, 40), (40, 8)]:
        vm.pointer_down(y, x)
    assert "polygon (4 vertices)" in vm.finish_polygon()
    assert vm.selection_mask[20, 20] == 1 and vm.selection_mask[50, 50] == 0 and vm._poly_vertices == []
    vm.set_selection_mode("brush")
    vm.brush_radius = 4
    vm.pointer_down(10, 10)
    vm.pointer_drag(10, 20)
    vm.pointer_up(10, 30)
    m = vm.selection_mask
    assert m[10, 10] == m[10, 20] == m[10, 30] == 1 and m[40, 40] == 0
    vm.pointer_down(-5, 1000)  # clipped, not fatal
    with pytest.raises(ValueError):
        vm.set_selection_mode("lasso")
    assert vm.clear_selection() == "selection cleared" and vm.selection_mask is None


def test_render_display_zmap_and_rubber_band(setup):
    """The canvas is the SR as uint8 with a yellow selection outline and a
    live rubber band; the Z map is the JAX view-model's image for the same
    Z. Renders reuse the cached SR: only a Z change runs the forward."""
    vm = make_vm(setup)
    jvm = JViewModel(JSession(setup.jforward, setup.params, setup.lr, n_steps=2))
    calls = []
    inner = vm.session.forward
    vm.session.forward = lambda lr, z: calls.append(1) or inner(lr, z)
    img = vm.render_display()
    assert img.shape == (64, 64, 3) and img.dtype == np.uint8
    vm.pointer_down(8, 8)
    vm.pointer_drag(20, 30)
    band = vm.render_display()
    assert (band[8, 8:31] == (255, 255, 0)).all() and (band[8:21, 30] == (255, 255, 0)).all()
    vm.pointer_up(31, 31)
    sel = vm.render_display()
    assert (sel[8, 8:32] == (255, 255, 0)).all() and len(calls) == 1
    assert (vm.zmap_image() == 255).all()
    z = np.random.default_rng(0).uniform(-1.5, 1.5, vm.session.z.shape).astype(np.float32)
    vm.session.z, jvm.session.z = z.copy(), z.copy()
    np.testing.assert_array_equal(vm.zmap_image(), jvm.zmap_image())
    vm.session._sr_cache = None
    vm.show_zmap = True
    assert vm.render_display().shape == (64, 64, 3) and len(calls) == 2
    m = np.zeros((8, 8), np.float32)
    m[2:6, 2:6] = 1
    edge = _mask_boundary(m)
    assert edge.sum() == 12 and not edge[3, 3]


def test_render_text_mask_contract():
    """A float [0, 1] mask of the box's shape with the text centred and
    shrunk to fit; an empty box raises. The glyphs are the port's bitmap
    font (printable ASCII; anything else draws as '?')."""
    alpha = render_text_mask("SR", (32, 64))
    assert alpha.shape == (32, 64) and alpha.dtype == np.float32
    assert 0.0 <= alpha.min() and alpha.max() <= 1.0 and alpha.max() > 0.5
    ys, xs = np.nonzero(alpha > 0)
    assert abs((ys.min() + ys.max()) / 2 - 15.5) <= 1.5 and abs((xs.min() + xs.max()) / 2 - 31.5) <= 1.5
    tiny = render_text_mask("HELLO WORLD", (10, 30))
    assert tiny.shape == (10, 30) and tiny.max() > 0
    small = render_text_mask("A", (40, 40), size=8)
    assert 0 < np.nonzero(small.any(axis=1))[0].size <= 8
    assert not render_text_mask("", (8, 8)).any() and not render_text_mask("   ", (8, 8)).any()
    np.testing.assert_array_equal(_text_bitmap("é"), _text_bitmap("?"))
    assert _text_bitmap("AB").shape == (7, 11)
    for box in ((0, 10), (10, 0)):
        with pytest.raises(ValueError):
            render_text_mask("x", box)


def test_imprint_text_and_image(setup):
    """Imprint a rendered text and an image patch (any size, resized to the
    selection's box) into the region; the SR stays CEM-consistent and the
    status reports the adaptive search."""
    vm = make_vm(setup)
    vm.session.set_search_strength(z_range_max=0)
    vm.pointer_down(8, 8)
    vm.pointer_up(39, 39)
    msg = vm.imprint_text("A", color=(1.0, 1.0, 1.0))
    assert msg.startswith("imprint 'A': loss") and "[adaptive:" in msg
    assert _residual(setup, vm.session.current_sr()) <= 1e-5
    assert "imprint: loss" in vm.imprint_image(np.full((13, 17, 3), 0.1, np.float32))
    assert "imprint: loss" in vm.imprint_image(np.full((64, 64, 3), 0.9, np.float32))
    assert _residual(setup, vm.session.current_sr()) <= 1e-5


def test_alternatives_picker(setup):
    vm = make_vm(setup)
    vm.pointer_down(0, 0)
    vm.pointer_up(31, 31)
    progress = []
    vm.on_progress = lambda done, total, losses: progress.append((done, total))
    assert "2 alternatives ready" in vm.generate_alternatives(k=2, seed=1)
    assert not vm.session.z.any() and (1, 2) in progress and (2, 2) in progress
    thumb = vm.candidate_image(1)
    assert thumb.dtype == np.uint8 and thumb.shape == (64, 64, 3)
    assert np.abs(vm.candidates[0][1] - vm.candidates[1][1]).max() > 1e-5
    for _, sr in vm.candidates:
        assert _residual(setup, sr) <= 1e-5
    chosen = vm.candidates[1][0].copy()
    assert vm.pick_alternative(1) == "applied alternative 1" and vm.candidates == []
    np.testing.assert_array_equal(vm.session.z, chosen)
    vm.undo()
    assert not vm.session.z.any()
    vm.generate_alternatives(k=1, seed=2)
    assert vm.cancel_alternatives() == "alternatives discarded" and vm.candidates == []
    with pytest.raises(IndexError):
        vm.pick_alternative(0)


def test_progress_status_and_search_controls(setup):
    """A listener switches the search to chunks with progress at each chunk's
    end; the status hook sees every message; steps and zmax reach the
    session."""
    vm = make_vm(setup, n_steps=8)
    events, statuses = [], []
    vm.on_progress = lambda done, total, losses: events.append((done, total, len(losses)))
    vm.on_status = statuses.append
    msg = vm.variance(+1)
    assert msg.startswith("variance +: loss") and statuses[-1] == msg
    assert events and events[-1] == (8, 8, 8) and [e[0] for e in events] == sorted(e[0] for e in events)
    assert vm.last_progress == (8, 8)
    vm.on_progress = None
    assert vm.session.progress_cb is None
    assert vm.set_search_steps(3) == "search steps set to 3" and vm.session._optimizer.n_steps == 3
    with pytest.raises(ValueError):
        vm.set_search_steps(0)
    assert "ceiling set to 2.5" in vm.set_z_range_max(2.5) and vm.session.z_range_max == 2.5
    assert "disabled" in vm.set_z_range_max(0) and vm.session.z_range_max is None
    for fn, want in ((lambda: vm.brightness(0.3), "brightness 0.3: loss"), (vm.smooth, "smooth: loss"),
                     (lambda: vm.periodicity(0, 4), "periodicity: loss"),
                     (lambda: vm.match_histogram(np.full((5, 5, 3), 0.5, np.float32)), "histogram: loss"),
                     (vm.undo, "undone"), (vm.redo, "redone"), (vm.reset_region, "region Z reset")):
        assert fn().startswith(want)
    with pytest.raises(ValueError, match="discriminator"):
        vm.realism(+1)


def test_session_io(setup, tmp_path):
    vm = make_vm(setup)
    vm.pointer_down(8, 8)
    vm.pointer_up(31, 31)
    vm.variance(+1)
    z, mask = vm.session.z.copy(), vm.selection_mask.copy()
    path = str(tmp_path / "session.npz")
    assert vm.save_session(path) == f"session saved to {path}"
    vm.variance(-1)
    vm.clear_selection()
    assert vm.load_session(path) == f"session loaded from {path}"
    np.testing.assert_array_equal(vm.session.z, z)
    np.testing.assert_array_equal(vm.selection_mask, mask)
    vm.undo()  # the history was cleared on load
    np.testing.assert_array_equal(vm.session.z, z)
    vm.save_image(str(tmp_path / "sr.png"))
    assert (tmp_path / "sr.png").exists()


# -- the Qt GUI over the fake binding ------------------------------------------


@pytest.fixture()
def fake_qt(monkeypatch):
    _PushButton.instances = []
    _Dialog.accept_next = True
    _install_fake_qt(monkeypatch)


def test_gui_actions_dialogs_and_pointer_events(fake_qt):
    """Every toolbar action, dialog flow and pointer event of the port's GUI
    maps to the intended view-model call."""
    vm = _SpyVM()
    gui.launch(vm)
    win = _MainWindow.last_instance
    tools = win.toolbars["tools"]
    expected = {"Var +": ("variance", 1), "Var -": ("variance", -1), "Realism +": ("realism", 1),
                "Realism -": ("realism", -1), "Smooth": ("smooth",), "Brightness": ("brightness", 0.5),
                "Imprint text": ("imprint_text", "graffiti"), "Undo": ("undo",), "Redo": ("redo",),
                "Reset Z": ("reset_region",)}
    for action, want in expected.items():
        before = len(vm.calls)
        tools.actions[action].trigger()
        assert want in vm.calls[before:], (action, vm.calls[before:])
    _InputDialog.next_double = [(3.0, True), (5.0, True)]
    tools.actions["Periodicity"].trigger()
    assert ("periodicity", 3.0, 5.0) in vm.calls
    _InputDialog.next_int, _InputDialog.next_double = [(48, True)], [(2.5, True)]
    tools.actions["Search strength"].trigger()
    assert ("set_search_steps", 48) in vm.calls and ("set_z_range_max", 2.5) in vm.calls
    tools.actions["Alternatives"].trigger()
    assert vm.called("generate_alternatives") and ("pick_alternative", 0) in vm.calls
    sel = win.toolbars["selection"]
    sel.actions["Finish polygon"].trigger()
    sel.actions["Clear"].trigger()
    sel.widgets[0].currentTextChanged.emit("brush")
    assert vm.called("finish_polygon") and vm.called("clear_selection") and ("set_selection_mode", "brush") in vm.calls

    class Ev:
        def pos(self):
            class P:
                def x(self):
                    return 4

                def y(self):
                    return 7

            return P()

    for handler in ("mousePressEvent", "mouseMoveEvent", "mouseReleaseEvent"):
        getattr(win.central, handler)(Ev())
    assert {("pointer_down", 7, 4), ("pointer_drag", 7, 4), ("pointer_up", 7, 4)} <= set(vm.calls)
    io_bar = win.toolbars["io"]
    _FileDialog.next_save = ("", "")
    io_bar.actions["Save image"].trigger()
    assert not vm.called("save_image")
    _FileDialog.next_save = ("/tmp/x.png", "png")
    io_bar.actions["Save image"].trigger()
    _FileDialog.next_open = ("/tmp/s.npz", "npz")
    io_bar.actions["Load session"].trigger()
    assert ("save_image", "/tmp/x.png") in vm.calls and ("load_session", "/tmp/s.npz") in vm.calls
    vm.on_status("hello")
    vm.on_progress(3, 8, None)
    bar = win._status.permanent[0]
    assert "hello" in win._status.messages and (bar.value, bar.maximum) == (3, 8)


def test_gui_drives_the_real_view_model(fake_qt, setup):
    """The GUI on a real view-model: a drag selects, Smooth runs a search
    (status and progress shown), Undo restores Z."""
    vm = make_vm(setup)
    gui.launch(vm)
    win = _MainWindow.last_instance

    class Ev:
        def __init__(self, y, x):
            self.p = (y, x)

        def pos(self):
            y, x = self.p

            class P:
                def x(self):
                    return x

                def y(self):
                    return y

            return P()

    win.central.mousePressEvent(Ev(4, 4))
    win.central.mouseMoveEvent(Ev(20, 24))
    win.central.mouseReleaseEvent(Ev(30, 30))
    assert vm.selection_mask[4:31, 4:31].all() and vm.selection_mask.sum() == 27 * 27
    win.toolbars["tools"].actions["Smooth"].trigger()
    assert vm.session.z.any() and any(m.startswith("smooth: loss") for m in win._status.messages)
    assert win._status.permanent[0].value == win._status.permanent[0].maximum == 2
    win.toolbars["tools"].actions["Undo"].trigger()
    assert not vm.session.z.any()


def test_gui_without_qt_names_the_cli(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_qt(name, *a, **kw):
        if name.startswith(("PyQt5", "PySide6")):
            raise ImportError(name)
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_qt)
    with pytest.raises(RuntimeError, match="esr_tpu_torch.explore.cli"):
        gui.launch(_SpyVM())
