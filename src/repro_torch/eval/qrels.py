"""Qrels — graded relevance judgments keyed by **external** doc ids
(the port's copy of ``repro/eval/qrels.py``: plain numpy, the same API
and padding conventions).

A ``Qrels`` is the classic TREC structure: for each query id, a
mapping from document id to a relevance grade (> 0 = relevant; higher
= more relevant). Document keys are the *external* ids the retrieval
engine hands out (``IndexBuilder.add`` / ``CorpusEngine.add_docs``
return them, ``search`` returns them back) — external ids survive
delta flushes, tombstoning and compaction by contract, so one Qrels
stays valid across the index's whole mutation history. Internal slot
numbering is never exposed here.

``to_arrays`` emits the padded ``(B, R)`` id/grade arrays the batched
metric path consumes; ``remap_docs`` translates doc keys when a
corpus is re-ingested under fresh external ids.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np


class Qrels:
    """Graded (query, doc, grade) judgments (see module docstring)."""

    def __init__(self,
                 judgments: Mapping[int, Mapping[int, float]] = None):
        self._by_q: Dict[int, Dict[int, float]] = {}
        for q, docs in (judgments or {}).items():
            self._by_q[int(q)] = {int(d): float(g)
                                  for d, g in docs.items()}

    # -- constructors ----------------------------------------------------

    @classmethod
    def from_triples(cls, triples: Iterable[Sequence[float]]) -> "Qrels":
        """From ``(query, doc, grade)`` rows — a list of tuples or an
        ``(M, 3)`` array (``data.synthetic.lsr_impact_corpus`` emits
        one). A repeated (query, doc) pair keeps the highest grade."""
        out = cls()
        for row in np.asarray(list(triples), dtype=np.float64).reshape(-1, 3):
            q, d, g = int(row[0]), int(row[1]), float(row[2])
            docs = out._by_q.setdefault(q, {})
            docs[d] = max(g, docs.get(d, g))
        return out

    @classmethod
    def paired(cls, n: int, *, grade: float = 1.0,
               doc_ids: Optional[Sequence[int]] = None) -> "Qrels":
        """Query i's sole relevant doc is ``doc_ids[i]`` (default: i) —
        the (query, positive-passage) pair shape of MS-MARCO-style
        training data and ``data.synthetic.lsr_pair_batches``."""
        ids = (np.arange(n) if doc_ids is None
               else np.asarray(list(doc_ids)))
        if ids.shape[0] != n:
            raise ValueError(f"{ids.shape[0]} doc ids for {n} queries")
        return cls({q: {int(ids[q]): grade} for q in range(n)})

    # -- lookups ---------------------------------------------------------

    @property
    def query_ids(self) -> List[int]:
        return sorted(self._by_q)

    @property
    def n_queries(self) -> int:
        return len(self._by_q)

    @property
    def n_judged(self) -> int:
        return sum(len(d) for d in self._by_q.values())

    @property
    def max_relevant(self) -> int:
        """Widest per-query judgment set (the R of ``to_arrays``)."""
        return max((len(d) for d in self._by_q.values()), default=0)

    def relevant(self, qid: int) -> Dict[int, float]:
        """``{doc: grade}`` for one query (a copy; empty if unjudged)."""
        return dict(self._by_q.get(int(qid), {}))

    def grade(self, qid: int, doc: int) -> float:
        return self._by_q.get(int(qid), {}).get(int(doc), 0.0)

    def __len__(self) -> int:
        return len(self._by_q)

    def __repr__(self) -> str:
        return (f"Qrels(n_queries={self.n_queries}, "
                f"n_judged={self.n_judged})")

    # -- transforms ------------------------------------------------------

    def remap_docs(self, mapping: Mapping[int, int],
                   *, strict: bool = True) -> "Qrels":
        """Qrels with doc keys translated through ``mapping`` (old
        external id -> new external id) — for a corpus re-ingested
        under fresh ids. ``strict=False`` drops unmapped docs instead
        of raising."""
        out: Dict[int, Dict[int, float]] = {}
        for q, docs in self._by_q.items():
            new: Dict[int, float] = {}
            for d, g in docs.items():
                if d in mapping:
                    new[int(mapping[d])] = g
                elif strict:
                    raise KeyError(
                        f"doc {d} (query {q}) has no entry in the "
                        f"remap — pass strict=False to drop it")
            if new:
                out[q] = new
        return Qrels(out)

    def to_arrays(self, query_ids: Optional[Sequence[int]] = None,
                  *, width: Optional[int] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Padded judgment arrays for the batched metric path.

        Returns ``(rel_ids (B, R) int64, rel_grades (B, R) float32)``
        over ``query_ids`` (default: all judged queries, sorted);
        unused slots hold id -1 / grade 0 — exactly the "no match"
        conventions ``metrics.ranked_grades`` treats as absent.
        ``width`` pins R (>= the widest requested judgment set).
        """
        qids = (self.query_ids if query_ids is None
                else [int(q) for q in query_ids])
        need = max((len(self._by_q.get(q, {})) for q in qids), default=0)
        r = width if width is not None else max(need, 1)
        if r < need:
            raise ValueError(f"width {r} < widest judgment set {need}")
        ids = np.full((len(qids), r), -1, np.int64)
        grades = np.zeros((len(qids), r), np.float32)
        for b, q in enumerate(qids):
            docs = self._by_q.get(q, {})
            for j, (d, g) in enumerate(sorted(docs.items())):
                ids[b, j] = d
                grades[b, j] = g
        return ids, grades
