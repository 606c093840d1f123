"""Qt GUI editor (port of esr_tpu/explore/gui.py): widget wiring over
:class:`EditorViewModel`.

Every editor behavior (selection modes, tools, alternatives picker, Z-map
view, history, session io, progress) lives in the headless view-model; this
module translates Qt events to view-model calls and paints its rendered
arrays. PyQt5 / PySide6 are imported only when the editor starts. Launch::

    python -m esr_tpu_torch.explore.gui -opt OPTIONS.json --lr image.png [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


def _require_qt():
    try:
        from PyQt5 import QtCore, QtGui, QtWidgets  # type: ignore

        return QtCore, QtGui, QtWidgets
    except ImportError:
        try:
            from PySide6 import QtCore, QtGui, QtWidgets  # type: ignore

            return QtCore, QtGui, QtWidgets
        except ImportError as e:
            raise RuntimeError(
                "No Qt binding available (PyQt5/PySide6). Use the terminal "
                "editor instead: python -m esr_tpu_torch.explore.cli"
            ) from e


def _to_qimage(QtGui, img: np.ndarray):
    h, w, _ = img.shape
    return QtGui.QImage(
        np.ascontiguousarray(img).data, w, h, 3 * w, QtGui.QImage.Format_RGB888
    )


def launch(vm) -> None:
    """Run the editor event loop around an EditorViewModel."""
    QtCore, QtGui, QtWidgets = _require_qt()

    app = QtWidgets.QApplication([])
    win = QtWidgets.QMainWindow()
    win.setWindowTitle("Explorable SR")

    canvas = QtWidgets.QLabel()
    canvas.setScaledContents(False)
    status = win.statusBar()
    progress = QtWidgets.QProgressBar()
    progress.setMaximumWidth(160)
    status.addPermanentWidget(progress)

    def refresh():
        canvas.setPixmap(QtGui.QPixmap.fromImage(_to_qimage(QtGui, vm.render_display())))

    vm.on_status = lambda msg: status.showMessage(msg)
    vm.on_progress = lambda done, total, _losses: (
        progress.setMaximum(total), progress.setValue(done), app.processEvents()
    )

    # -- pointer events -> view-model selection protocol --------------------
    def pos(ev):
        p = ev.pos()
        return p.y(), p.x()

    canvas.mousePressEvent = lambda ev: (vm.pointer_down(*pos(ev)), refresh())
    canvas.mouseMoveEvent = lambda ev: (vm.pointer_drag(*pos(ev)), refresh())
    canvas.mouseReleaseEvent = lambda ev: (vm.pointer_up(*pos(ev)), refresh())
    canvas.mouseDoubleClickEvent = lambda ev: (vm.finish_polygon(), refresh())

    # -- selection toolbar ----------------------------------------------------
    sel_bar = win.addToolBar("selection")
    mode_box = QtWidgets.QComboBox()
    mode_box.addItems(["rect", "polygon", "brush"])
    mode_box.currentTextChanged.connect(vm.set_selection_mode)
    sel_bar.addWidget(mode_box)
    radius = QtWidgets.QSpinBox()
    radius.setRange(1, 128)
    radius.setValue(vm.brush_radius)
    radius.valueChanged.connect(lambda r: setattr(vm, "brush_radius", int(r)))
    sel_bar.addWidget(radius)
    sel_bar.addAction("Finish polygon").triggered.connect(
        lambda: (vm.finish_polygon(), refresh())
    )
    sel_bar.addAction("Clear").triggered.connect(lambda: (vm.clear_selection(), refresh()))
    zmap_act = sel_bar.addAction("Z map")
    zmap_act.setCheckable(True)
    zmap_act.toggled.connect(lambda on: (setattr(vm, "show_zmap", on), refresh()))

    # -- tools toolbar ---------------------------------------------------------
    def ask_float(title, lo, hi, default):
        v, ok = QtWidgets.QInputDialog.getDouble(win, title, title, default, lo, hi, 2)
        return v if ok else None

    def do_imprint_text():
        text, ok = QtWidgets.QInputDialog.getText(win, "Imprint text", "Text:")
        if ok and text:
            vm.imprint_text(text)
            refresh()

    def do_imprint_image():
        path, _ = QtWidgets.QFileDialog.getOpenFileName(win, "Imprint image")
        if path:
            from esr_tpu_torch.data.util import read_img

            vm.imprint_image(read_img(path))
            refresh()

    def do_histogram():
        path, _ = QtWidgets.QFileDialog.getOpenFileName(win, "Histogram target patch")
        if path:
            from esr_tpu_torch.data.util import read_img

            vm.match_histogram(read_img(path))
            refresh()

    def do_brightness():
        v = ask_float("Target brightness", 0.0, 1.0, 0.5)
        if v is not None:
            vm.brightness(v)
            refresh()

    def do_periodicity():
        py = ask_float("Period Y (px, 0=off)", 0.0, 256.0, 0.0)
        px = ask_float("Period X (px, 0=off)", 0.0, 256.0, 8.0)
        if py is not None and px is not None and (py or px):
            vm.periodicity(py, px)
            refresh()

    def do_search_strength():
        # editor-level Z-search controls: steps budget + adaptive z-range
        # ceiling, the same knobs as the CLI's `steps` / `zmax`
        try:  # current values for dialog defaults (vm may be a test double)
            cur_steps = int(vm.session._optimizer.n_steps)
            cur_zmax = float(vm.session.z_range_max or 0.0)
        except (AttributeError, TypeError):
            cur_steps, cur_zmax = 64, 3.0
        n, ok = QtWidgets.QInputDialog.getInt(
            win, "Search steps", "Z-search steps per tool run:",
            cur_steps, 1, 4096,
        )
        if ok:
            vm.set_search_steps(n)
        zr = ask_float(
            "Adaptive z-range ceiling (0 = stay in trained box)", 0.0, 16.0,
            cur_zmax,
        )
        if zr is not None:
            vm.set_z_range_max(zr)

    def do_alternatives():
        vm.generate_alternatives(k=3)
        dlg = QtWidgets.QDialog(win)
        dlg.setWindowTitle("Pick an alternative")
        lay = QtWidgets.QHBoxLayout(dlg)
        for i in range(len(vm.candidates)):
            btn = QtWidgets.QPushButton()
            thumb = vm.candidate_image(i)
            btn.setIcon(QtGui.QIcon(QtGui.QPixmap.fromImage(_to_qimage(QtGui, thumb))))
            btn.setIconSize(QtCore.QSize(192, 192))
            btn.clicked.connect(lambda _=False, j=i: (vm.pick_alternative(j), dlg.accept()))
            lay.addWidget(btn)
        if dlg.exec_() != QtWidgets.QDialog.Accepted:
            vm.cancel_alternatives()
        refresh()

    tools = win.addToolBar("tools")
    for name, fn in [
        ("Var +", lambda: (vm.variance(+1), refresh())),
        ("Var -", lambda: (vm.variance(-1), refresh())),
        ("Realism +", lambda: (vm.realism(+1), refresh())),
        ("Realism -", lambda: (vm.realism(-1), refresh())),
        ("Smooth", lambda: (vm.smooth(), refresh())),
        ("Brightness", do_brightness),
        ("Periodicity", do_periodicity),
        ("Imprint text", do_imprint_text),
        ("Imprint image", do_imprint_image),
        ("Histogram", do_histogram),
        ("Alternatives", do_alternatives),
        ("Search strength", do_search_strength),
        ("Undo", lambda: (vm.undo(), refresh())),
        ("Redo", lambda: (vm.redo(), refresh())),
        ("Reset Z", lambda: (vm.reset_region(), refresh())),
    ]:
        tools.addAction(name).triggered.connect(lambda _=False, f=fn: f())

    # -- io toolbar --------------------------------------------------------------
    io_bar = win.addToolBar("io")

    def do_save_img():
        path, _ = QtWidgets.QFileDialog.getSaveFileName(win, "Save SR", "sr.png")
        if path:
            vm.save_image(path)

    def do_save_session():
        path, _ = QtWidgets.QFileDialog.getSaveFileName(win, "Save session", "session.npz")
        if path:
            vm.save_session(path)

    def do_load_session():
        path, _ = QtWidgets.QFileDialog.getOpenFileName(win, "Load session")
        if path:
            vm.load_session(path)
            refresh()

    io_bar.addAction("Save image").triggered.connect(do_save_img)
    io_bar.addAction("Save session").triggered.connect(do_save_session)
    io_bar.addAction("Load session").triggered.connect(do_load_session)

    win.setCentralWidget(canvas)
    refresh()
    win.show()
    app.exec_()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", required=True)
    parser.add_argument("--lr", required=True)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    from esr_tpu_torch.explore.cli import build_session_from_opt
    from esr_tpu_torch.explore.viewmodel import EditorViewModel

    launch(EditorViewModel(build_session_from_opt(args.opt, args.lr, device=args.device)))


if __name__ == "__main__":
    main()
