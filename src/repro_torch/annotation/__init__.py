"""Annotation-service runtime (``repro.annotation``): the human side of
MCAL.

    AnnotatorPool / AnnotatorConfig    seeded noisy worker pools
    VoteAggregator                     device majority + Dawid-Skene EM
    majority_vote_host / dawid_skene_host   the NumPy reference oracles
    AnnotationService / RepeatPolicy   request broker + budget ledger
    AnnotationSession                  per-tenant view of a shared service
    make_annotation_service            one-call construction
"""
from repro_torch.annotation.aggregate import (AggregateConfig,  # noqa: F401
                                              DSResult, ResidentVotes,
                                              VoteAggregator,
                                              dawid_skene_host,
                                              majority_vote_host,
                                              vote_counts_host)
from repro_torch.annotation.oracle import (AnnotatorConfig,  # noqa: F401
                                           AnnotatorPool,
                                           make_annotator_pool)
from repro_torch.annotation.service import (AGGREGATORS,  # noqa: F401
                                            AnnotationService,
                                            AnnotationSession,
                                            BudgetExceeded, RepeatPolicy,
                                            make_annotation_service)
