# Copied from multiprime_tpu/validate/metrics.py (host code, no JAX).
"""Experimental-validation metrics (ROC.py / gradient / dimer-correlation
equivalents) without the sklearn/matplotlib dependencies.

* roc_analysis        — ACC / MCC / ROC-AUC of capture predictions
  (test_data/ROC/ROC.py semantics: ACC rounds both sides, AUC by the
  trapezoid over the ranked ROC curve)
* pair_coverage_join  — predicted vs scan-measured pair coverage
  (Primer_pair_coverage_for_gradient.py:68-125)
* dimer_correlation   — predicted Loss/dG sums vs experimental dimer data
  (dimer_prediction_exp_correlation.py:52-87)
"""

from __future__ import annotations

import math

import numpy as np


def acc(y_true, y_pred):
    y_true = np.asarray(y_true, float)
    y_pred = np.asarray(y_pred, float)
    hits = sum(round(float(a)) == round(float(b))
               for a, b in zip(y_true, y_pred))
    return round(hits / len(y_pred), 2)


def mcc(y_true, y_pred):
    t = np.asarray(np.round(y_true), int)
    p = np.asarray(np.round(y_pred), int)
    tp = int(((t == 1) & (p == 1)).sum())
    tn = int(((t == 0) & (p == 0)).sum())
    fp = int(((t == 0) & (p == 1)).sum())
    fn = int(((t == 1) & (p == 0)).sum())
    denom = math.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    if denom == 0:
        return 0.0
    return (tp * tn - fp * fn) / denom


def roc_curve_points(y_true, scores):
    y_true = np.asarray(y_true, float)
    scores = np.asarray(scores, float)
    order = np.argsort(-scores, kind="stable")
    y = y_true[order]
    s = scores[order]
    tps = np.cumsum(y)
    fps = np.cumsum(1 - y)
    # keep last point of each distinct threshold
    distinct = np.concatenate([np.diff(s) != 0, [True]])
    tps, fps = tps[distinct], fps[distinct]
    tpr = np.concatenate([[0.0], tps / max(tps[-1], 1)])
    fpr = np.concatenate([[0.0], fps / max(fps[-1], 1)])
    return fpr, tpr


def roc_auc(y_true, scores):
    fpr, tpr = roc_curve_points(y_true, scores)
    return float(np.trapezoid(tpr, fpr))


def roc_plot(fpr, tpr, auc, out_dir, title="ROC"):
    """Write roc.<auc>.png/.pdf like ROC.py's plotauc
    (test_data/ROC/ROC.py:22-29: blue curve, 'AUC = %0.2f' legend lower
    right, TPR/FPR axis labels).  Returns the written paths, or [] when
    matplotlib is unavailable."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # pragma: no cover - matplotlib is in the image
        return []
    fig = plt.figure()
    plt.title(title)
    plt.plot(fpr, tpr, "b", label="AUC = %0.2f" % auc)
    plt.legend(loc="lower right")
    plt.ylabel("True Positive Rate")
    plt.xlabel("False Positive Rate")
    paths = []
    for ext in ("png", "pdf"):
        p = "%s/roc.%s.%s" % (out_dir, auc, ext)
        fig.savefig(p)
        paths.append(p)
    plt.close(fig)
    return paths


def roc_analysis(csv_path, out_path=None, plot_dir=None):
    """ROC.csv (sample,real,predict) -> dict of ACC/MCC/AUC (+tsv report,
    + roc.<auc>.png/.pdf when ``plot_dir`` is given)."""
    rows = [line.strip().split(",") for line in
            open(csv_path, encoding="utf-8-sig").read().splitlines()[1:]
            if line.strip()]
    real = np.array([float(r[1]) for r in rows])
    pred = np.array([float(r[2]) for r in rows])
    result = {"acc": acc(real, pred), "mcc": mcc(real, pred),
              "auc": roc_auc(real, pred)}
    if out_path:
        with open(out_path, "w") as f:
            f.write("metric\tvalue\n")
            for k, v in result.items():
                f.write("%s\t%s\n" % (k, v))
    if plot_dir:
        fpr, tpr = roc_curve_points(real, pred)
        result["plots"] = roc_plot(fpr, tpr, result["auc"], plot_dir)
    return result


def gradient_join(candidate_txt, bwt_pair_num, ref_fa, out, step=5):
    """Primer_pair_coverage_for_gradient.py's exact file contract
    (:68-125): join the designed pair coverage (candidate txt, stride
    ``step`` fields per pair, coverage = field3 "len:Tm:cov", key =
    field5 "start:stop") against the BWT scan's .pair.num rows (start/stop
    recovered from the primer IDs' "_<pos>_F/R" suffixes, measured =
    column 3 / sequence count rounded to 4)."""
    coverage_by_pos = {}
    with open(candidate_txt) as f:
        for line in f:
            if line.startswith("#"):
                continue
            fields = line.strip().split("\t")
            n = 0
            while n < len(fields) - 3:
                coverage_by_pos[fields[n + 5]] = \
                    fields[n + 3].split(":")[2]
                n += step
    n_newlines = 0
    with open(ref_fa, encoding="utf-8") as f:
        for chunk in iter(lambda: f.read(1 << 20), ""):
            n_newlines += chunk.count("\n")
    seq_number = int(n_newlines / 2)
    with open(out, "w") as o:
        o.write("\t".join(["Primer_F", "Primer_R", "coverage_of_multiPrime",
                           "estimate_coverage_by BWT"]) + "\n")
        with open(bwt_pair_num) as f:
            for line in f:
                if line.startswith("Primer_F"):
                    continue
                fields = line.strip().split("\t")
                start = fields[0].split("_")[-2]
                stop = fields[1].split("_")[-2]
                key = start + ":" + stop
                if key in coverage_by_pos:
                    o.write("\t".join(map(str, [
                        fields[0], fields[1], coverage_by_pos[key],
                        round(int(fields[3]) / seq_number, 4)])) + "\n")
    return seq_number


def dimer_exp_correlation(findimer_out, exp_file, out):
    """dimer_prediction_exp_correlation.py's exact file contract (:45-76):
    per sorted primer-name pair, mean Loss (col 10) and mean dG (col 3)
    from the finDimer table vs the summed experimental signal (col 2),
    written in first-file insertion order with the reference's rounding
    (including round() of the integer experimental sum)."""
    loss, dg, num, exp = {}, {}, {}, {}
    with open(findimer_out) as f1:
        for line in f1:
            if line.startswith("Primer"):
                continue
            fields = line.strip().split("\t")
            key = " | ".join(sorted([fields[0].lstrip(">"),
                                     fields[7].lstrip(">")]))
            loss[key] = loss.get(key, 0) + float(fields[10])
            dg[key] = dg.get(key, 0) + float(fields[3])
            num[key] = num.get(key, 0) + 1
    with open(exp_file) as f2:
        for line in f2:
            fields = line.strip().split("\t")
            key = " | ".join(sorted([fields[0], fields[1]]))
            exp[key] = exp.get(key, 0) + int(fields[2])
    with open(out, "w") as o:
        for key in loss.keys():
            measured = str(round(exp[key], 2)) if key in exp else "0"
            o.write(key + "\t" + str(round(loss[key] / num[key], 2))
                    + "\t" + str(round(dg[key] / num[key], 2))
                    + "\t" + measured + "\n")


def pair_coverage_join(predicted_rows, scanned_pair_counts):
    """Join designed pair coverage vs scan-measured counts.

    predicted_rows: iterable of (primer_f, primer_r, predicted_count)
    scanned_pair_counts: {"F\\tR": measured}
    -> list of (F, R, predicted, measured)
    """
    out = []
    for f, r, pred in predicted_rows:
        out.append((f, r, pred, scanned_pair_counts.get(f + "\t" + r, 0)))
    return out


def dimer_correlation(predicted, experimental):
    """Pearson r between predicted dimer scores and experimental signal."""
    x = np.asarray(predicted, float)
    y = np.asarray(experimental, float)
    if x.std() == 0 or y.std() == 0:
        return 0.0
    return float(np.corrcoef(x, y)[0, 1])
