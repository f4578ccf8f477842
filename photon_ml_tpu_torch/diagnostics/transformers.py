"""Diagnostic reports → logical document (the reference's *ToPhysicalReport
transformers, diagnostics/reporting/*Transformer.scala, collapsed into one
module building a :class:`Document` the text/HTML renderers consume).

A copy of ``photon_ml_tpu/diagnostics/transformers.py`` (numpy and scipy only),
importing the port's own modules.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

from photon_ml_tpu_torch.diagnostics.reports import (
    BootstrapReport,
    FeatureImportanceReport,
    FittingReport,
    HosmerLemeshowReport,
    PredictionErrorIndependenceReport,
)
from photon_ml_tpu_torch.diagnostics.reporting import (
    BulletedList,
    Chapter,
    Document,
    LinePlot,
    Section,
    SimpleText,
    Table,
)


def hosmer_lemeshow_section(report: HosmerLemeshowReport) -> Section:
    rows = [[f"[{b.lower:.2f}, {b.upper:.2f})",
             f"{b.observed_pos:.1f}", f"{b.expected_pos:.1f}",
             f"{b.observed_neg:.1f}", f"{b.expected_neg:.1f}"]
            for b in report.bins]
    items = [
        SimpleText(
            f"Chi^2 = {report.chi_square:.4f} with "
            f"{report.degrees_of_freedom} degrees of freedom "
            f"(p = {report.p_value:.4g})"),
        Table(header=["probability bin", "obs+", "exp+", "obs-", "exp-"],
              rows=rows, caption="Predicted probability vs observed "
                                 "frequency"),
    ]
    if report.messages:
        items.append(BulletedList(report.messages))
    return Section("Hosmer-Lemeshow goodness-of-fit", items)


def feature_importance_section(report: FeatureImportanceReport) -> Section:
    rows = [[name, term, str(idx), f"{imp:.6g}"]
            for (name, term), (idx, imp)
            in sorted(report.feature_importance.items(),
                      key=lambda kv: -kv[1][1])]
    return Section(
        f"Feature importance ({report.importance_type})",
        [SimpleText(report.importance_description),
         Table(header=["name", "term", "index", "importance"], rows=rows),
         Table(header=["decile", "importance threshold"],
               rows=[[str(d), f"{v:.6g}"]
                     for d, v in sorted(report.rank_to_importance.items())],
               caption="importance deciles")])


def independence_section(report: PredictionErrorIndependenceReport
                         ) -> Section:
    kt = report.kendall_tau
    items = [
        Table(header=["statistic", "value"],
              rows=[["concordant pairs", str(kt.concordant)],
                    ["discordant pairs", str(kt.discordant)],
                    ["ties (predictions)", str(kt.ties_a)],
                    ["ties (errors)", str(kt.ties_b)],
                    ["tau-alpha", f"{kt.tau_alpha:.6g}"],
                    ["tau-beta", f"{kt.tau_beta:.6g}"],
                    ["z (alpha)", f"{kt.z_alpha:.4g}"],
                    ["p-value", f"{kt.p_value:.4g}"]],
              caption="Kendall tau: prediction vs error independence")]
    if kt.message:
        items.append(SimpleText(kt.message))
    return Section("Prediction-error independence", items)


def fitting_chapter(reports: Mapping[float, FittingReport]) -> Chapter:
    sections = []
    for lam, report in sorted(reports.items()):
        items = []
        for metric, curve in sorted(report.metrics.items()):
            items.append(LinePlot(
                x=curve.portions,
                series={"train": curve.train_values,
                        "holdout": curve.test_values},
                title=f"{metric} vs training-data portion",
                x_label="% of training data", y_label=metric))
        if report.message:
            items.append(SimpleText(report.message))
        sections.append(Section(f"lambda = {lam:g}", items))
    return Chapter("Learning curves (fitting diagnostic)", sections)


def bootstrap_chapter(reports: Mapping[float, BootstrapReport],
                      index_map=None) -> Chapter:
    sections = []
    for lam, report in sorted(reports.items()):
        items = []
        if report.metric_summaries:
            items.append(Table(
                header=["metric", "min", "q1", "median", "q3", "max",
                        "mean", "std"],
                rows=[[m, f"{s.min:.4g}", f"{s.q1:.4g}", f"{s.median:.4g}",
                       f"{s.q3:.4g}", f"{s.max:.4g}", f"{s.mean:.4g}",
                       f"{s.std:.4g}"]
                      for m, s in sorted(report.metric_summaries.items())],
                caption="bootstrapped metric distributions"))
        if report.straddling_zero:
            names = []
            for j in report.straddling_zero[:50]:
                key = (index_map.key_of(j) if index_map is not None
                       else None)
                names.append(key if key is not None else f"index {j}")
            items.append(
                SimpleText(f"{len(report.straddling_zero)} coefficients "
                           f"whose bootstrap IQR straddles zero:"))
            items.append(BulletedList(names))
        sections.append(Section(f"lambda = {lam:g}", items))
    return Chapter("Bootstrap confidence intervals", sections)


def build_diagnostic_document(
        title: str,
        hl: Optional[HosmerLemeshowReport] = None,
        importance: Optional[list[FeatureImportanceReport]] = None,
        independence: Optional[PredictionErrorIndependenceReport] = None,
        fitting: Optional[Mapping[float, FittingReport]] = None,
        bootstrap: Optional[Mapping[float, BootstrapReport]] = None,
        index_map=None,
        preamble: str = "") -> Document:
    """Assemble the full diagnostic report document
    (Driver.scala:618-638's report assembly analog)."""
    doc = Document(title)
    model_sections = []
    if preamble:
        model_sections.append(Section("Run summary",
                                      [SimpleText(preamble)]))
    if hl is not None:
        model_sections.append(hosmer_lemeshow_section(hl))
    for rep in importance or []:
        model_sections.append(feature_importance_section(rep))
    if independence is not None:
        model_sections.append(independence_section(independence))
    if model_sections:
        doc.chapters.append(Chapter("Model diagnostics", model_sections))
    if fitting:
        doc.chapters.append(fitting_chapter(fitting))
    if bootstrap:
        doc.chapters.append(bootstrap_chapter(bootstrap, index_map))
    return doc
