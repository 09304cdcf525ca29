"""Evaluation export helpers (reference `evaluation/EvaluationTools.java` —
ROC/PR chart HTML export built on the UI component DSL); the port of
`deeplearning4j_tpu/eval/tools.py`, writing the same HTML for the same
curves.
"""
from __future__ import annotations

from typing import Optional

from .evaluation import Evaluation
from .roc import ROC, ROCMultiClass

__all__ = ["EvaluationTools"]


class EvaluationTools:
    @staticmethod
    def roc_chart_html(roc: ROC, title: str = "ROC") -> str:
        from ..ui.components import (ChartLine, ComponentText, StyleChart,
                                     render_page)

        curve = roc.get_roc_curve()          # [(threshold, fpr, tpr)]
        fpr = [p[1] for p in curve]
        tpr = [p[2] for p in curve]
        chart = (ChartLine(f"{title} (AUC={roc.calculate_auc():.4f})",
                           StyleChart(520, 320))
                 .add_series("ROC", fpr, tpr)
                 .add_series("chance", [0.0, 1.0], [0.0, 1.0]))
        pr = roc.get_precision_recall_curve()
        comps = [chart]
        if pr:
            rec = [p[1] for p in pr]
            prec = [p[2] for p in pr]
            comps.append(
                ChartLine(f"Precision-Recall "
                          f"(AUPRC={roc.calculate_auprc():.4f})",
                          StyleChart(520, 320))
                .add_series("PR", rec, prec))
        comps.append(ComponentText(
            f"AUC: {roc.calculate_auc():.6f} — "
            f"AUPRC: {roc.calculate_auprc():.6f}"))
        return render_page(title, comps)

    @staticmethod
    def export_roc_charts_to_html_file(roc: ROC, path: str,
                                       title: str = "ROC"):
        """`EvaluationTools.exportRocChartsToHtmlFile` parity."""
        with open(path, "w") as f:
            f.write(EvaluationTools.roc_chart_html(roc, title))

    @staticmethod
    def roc_multi_class_chart_html(roc: ROCMultiClass,
                                   title: str = "ROC (one-vs-all)") -> str:
        from ..ui.components import ChartLine, StyleChart, render_page

        chart = ChartLine(title, StyleChart(560, 340))
        for cls in range(roc.num_classes):
            curve = roc.get_roc_curve(cls)
            chart.add_series(
                f"class {cls} (AUC={roc.calculate_auc(cls):.3f})",
                [p[1] for p in curve], [p[2] for p in curve])
        return render_page(title, [chart])

    @staticmethod
    def export_confusion_matrix_html_file(ev: Evaluation, path: str,
                                          title: str = "Evaluation"):
        from ..ui.components import (ComponentTable, ComponentText,
                                     render_page)

        m = ev._m   # empty (0, 0) matrix when nothing evaluated yet
        n = m.shape[0]
        if n == 0:
            comps = [ComponentText("accuracy n/a — no examples evaluated")]
            with open(path, "w") as f:
                f.write(render_page(title, comps))
            return
        names = (ev.label_names
                 if ev.label_names and len(ev.label_names) == n
                 else [str(i) for i in range(n)])
        header = ["actual \\ predicted"] + list(names)
        rows = [[names[i]] + [int(v) for v in m[i]] for i in range(n)]
        comps = [ComponentText(
            f"accuracy {ev.accuracy():.4f} — precision "
            f"{ev.precision():.4f} — recall {ev.recall():.4f} — F1 "
            f"{ev.f1():.4f}"), ComponentTable(header, rows)]
        with open(path, "w") as f:
            f.write(render_page(title, comps))
