"""EvaluationTools: HTML report export (counterpart of
``deeplearning4j_tpu/evaluation/tools.py``).

Mirrors deeplearning4j-core evaluation/EvaluationTools.java (ROC chart
+ confusion matrix HTML exports). Self-contained HTML with inline SVG.
"""

from __future__ import annotations

__all__ = ["export_evaluation_html", "export_roc_html",
           "export_calibration_html"]


def _svg_polyline(xs, ys, w=420, h=300, color="#36c"):
    pts = " ".join(
        f"{30 + x * (w - 50):.1f},{h - 25 - y * (h - 50):.1f}"
        for x, y in zip(xs, ys))
    return (f'<svg width="{w}" height="{h}">'
            f'<rect x="30" y="25" width="{w-50}" height="{h-50}" '
            f'fill="none" stroke="#ccc"/>'
            f'<line x1="30" y1="{h-25}" x2="{w-20}" y2="25" '
            f'stroke="#ddd" stroke-dasharray="4"/>'
            f'<polyline points="{pts}" fill="none" stroke="{color}" '
            f'stroke-width="2"/></svg>')


def export_evaluation_html(evaluation, path: str,
                           title: str = "Evaluation") -> None:
    ev = evaluation
    n = ev.n_classes or 0
    rows = []
    for i in range(n):
        rows.append(
            f"<tr><td>{i}</td><td>{ev.precision(i):.4f}</td>"
            f"<td>{ev.recall(i):.4f}</td><td>{ev.f1(i):.4f}</td></tr>")
    conf_rows = []
    if ev.confusion is not None:
        for i in range(n):
            cells = "".join(f"<td>{ev.confusion.matrix[i, j]}</td>"
                            for j in range(n))
            conf_rows.append(f"<tr><th>{i}</th>{cells}</tr>")
    html = f"""<!DOCTYPE html><html><head><title>{title}</title>
<style>body{{font-family:sans-serif;margin:2em}}table{{border-collapse:
collapse}}td,th{{border:1px solid #ccc;padding:4px 10px}}</style></head>
<body><h1>{title}</h1>
<p>Accuracy {ev.accuracy():.4f} &middot; Precision {ev.precision():.4f}
&middot; Recall {ev.recall():.4f} &middot; F1 {ev.f1():.4f}</p>
<h2>Per-class</h2>
<table><tr><th>class</th><th>precision</th><th>recall</th><th>f1</th>
</tr>{''.join(rows)}</table>
<h2>Confusion matrix (rows = actual)</h2>
<table><tr><th></th>{''.join(f'<th>{j}</th>' for j in range(n))}</tr>
{''.join(conf_rows)}</table>
</body></html>"""
    with open(path, "w") as f:
        f.write(html)


def _svg_bars(counts, w=420, h=220, color="#593"):
    total = max(1, int(max(counts))) if len(counts) else 1
    n = max(1, len(counts))
    bw = (w - 50) / n
    bars = "".join(
        f'<rect x="{30 + i * bw:.1f}" '
        f'y="{h - 25 - (c / total) * (h - 50):.1f}" '
        f'width="{max(1.0, bw - 1):.1f}" '
        f'height="{(c / total) * (h - 50):.1f}" fill="{color}"/>'
        for i, c in enumerate(counts))
    return (f'<svg width="{w}" height="{h}">'
            f'<rect x="30" y="25" width="{w-50}" height="{h-50}" '
            f'fill="none" stroke="#ccc"/>{bars}</svg>')


def export_calibration_html(calibration, path: str,
                            title: str = "Calibration") -> None:
    """Reliability diagrams + ECE per class, the overall residual
    plot and probability histogram (the calibration charts the
    reference's UI renders from EvaluationCalibration)."""
    ec = calibration
    n = ec.num_classes()
    if n < 0:
        raise ValueError(
            "EvaluationCalibration has no data — call eval() before "
            "exporting")
    sections = []
    for i in range(max(0, n)):
        mean_pred, observed = ec.reliability_diagram(i)
        sections.append(
            f"<h2>Class {i} reliability "
            f"(ECE {ec.expected_calibration_error(i):.4f})</h2>"
            + _svg_polyline(list(mean_pred), list(observed)))
    _, resid = ec.residual_plot()
    _, hist = ec.probability_histogram()
    html = f"""<!DOCTYPE html><html><head><title>{title}</title>
<style>body{{font-family:sans-serif;margin:2em}}</style></head>
<body><h1>{title}</h1>
{''.join(sections)}
<h2>Residual plot |label &minus; p| (all classes)</h2>
{_svg_bars(list(resid))}
<h2>Probability histogram (all classes)</h2>
{_svg_bars(list(hist), color="#36c")}
</body></html>"""
    with open(path, "w") as f:
        f.write(html)


def export_roc_html(roc, path: str, title: str = "ROC") -> None:
    curve = roc.get_roc_curve()
    pr = roc.get_precision_recall_curve()
    auc = roc.calculate_auc()
    html = f"""<!DOCTYPE html><html><head><title>{title}</title>
<style>body{{font-family:sans-serif;margin:2em}}</style></head>
<body><h1>{title}</h1><p>AUC = {auc:.4f}</p>
<h2>ROC curve</h2>{_svg_polyline(curve.fpr, curve.tpr)}
<h2>Precision-Recall</h2>
{_svg_polyline(pr.recall, pr.precision, color="#c33")}
</body></html>"""
    with open(path, "w") as f:
        f.write(html)
