"""Typed exception hierarchy.

Reference (what): CORE/exception/* — ~20 typed exceptions rooted at
RuntimeException, each carrying query-context info where available
(e.g. SiddhiAppCreationException, ConnectionUnavailableException,
CannotRestoreSiddhiAppStateException).  TPU design (how): one Python
hierarchy rooted at SiddhiError; compile-time errors keep the line/column
context the tokenizer attaches, runtime errors name the query so fault
streams (@OnError) can route them.
"""
from __future__ import annotations


class SiddhiError(Exception):
    """Root of the framework's exception hierarchy."""


# -- compile time -------------------------------------------------------------
class CompileError(SiddhiError):
    """Expression/query cannot be compiled to a device function
    (reference: SiddhiAppCreationException)."""


class SiddhiParserException(CompileError):
    """SiddhiQL text failed to parse (reference:
    QC/exception/SiddhiParserException)."""


class SiddhiAppValidationError(CompileError):
    """App-level semantic validation failed (reference:
    SiddhiAppValidationException)."""


class DuplicateDefinitionError(CompileError):
    """Two definitions share an id (reference:
    DuplicateDefinitionException)."""


class DefinitionNotExistError(CompileError, KeyError):
    """A query references an undefined stream/table/window/aggregation
    (reference: DefinitionNotExistException).  Subclasses KeyError for
    backward compatibility with callers catching the untyped lookup error."""


class OperationNotSupportedError(CompileError):
    """Valid SiddhiQL that this engine does not (yet) execute (reference:
    OperationNotSupportedException)."""


# -- runtime ------------------------------------------------------------------
class SiddhiAppRuntimeError(SiddhiError):
    """Event-processing failure inside a running app (reference:
    SiddhiAppRuntimeException)."""


class QueryNotExistError(SiddhiError, KeyError):
    """Callback/on-demand query addressed a query id that is not part of
    the app (reference: QueryNotExistException).  Subclasses KeyError for
    backward compatibility with callers catching the untyped lookup error."""


class MatchOverflowError(SiddhiAppRuntimeError):
    """Pattern matches exceeded the implicit per-key emission capacity; the
    batch would silently lose rows.  Set @emit(rows='N') to raise the cap
    or explicitly accept capped delivery."""


class CapacityExceededError(SiddhiAppRuntimeError, RuntimeError):
    """A fixed-capacity state slab (key slots, window rows) is full.
    Subclasses RuntimeError for backward compatibility with callers that
    caught the untyped error."""


class AdmissionDeniedError(SiddhiError):
    """The admission controller (core/admission.py) refused the request:
    a deploy whose static state estimate exceeds the configured memory
    ceiling, or an ingest send that exhausted its `block` deadline.
    `components` carries the per-component byte breakdown for memory
    denials (the same breakdown lint MEM001 cites), empty otherwise."""

    def __init__(self, message: str, components=None):
        super().__init__(message)
        self.components = dict(components or {})


class OnDemandQueryCreationError(CompileError):
    """On-demand (store) query failed to compile (reference:
    OnDemandQueryCreationException)."""


# -- persistence --------------------------------------------------------------
class PersistenceError(SiddhiError):
    """Snapshot persist failed (reference: PersistenceStoreException)."""


class NoPersistenceStoreError(PersistenceError):
    """persist() called with no PersistenceStore configured (reference:
    NoPersistenceStoreException)."""


class CannotRestoreStateError(PersistenceError):
    """Snapshot restore failed or revision missing (reference:
    CannotRestoreSiddhiAppStateException)."""


class CorruptSnapshotError(PersistenceError):
    """A stored snapshot failed its CRC32 integrity check (torn write,
    truncation, or bit rot).  restore_last_revision() treats this as
    "skip to the previous good revision", never as fatal."""


# -- I/O ----------------------------------------------------------------------
class ConnectionUnavailableError(SiddhiError):
    """Source/sink/store backing system unreachable (reference:
    CORE/exception/ConnectionUnavailableException).  Transports raise
    THIS (not bare OSError/ValueError) for connectivity failures so the
    resilience layer (io/resilience.py) can distinguish a retryable
    transport outage from an application bug."""


# historical name, kept importable: pre-resilience code and extensions
# caught the Java-style spelling
ConnectionUnavailableException = ConnectionUnavailableError


class MappingFailedError(SiddhiAppRuntimeError):
    """Source/sink mapper could not convert a payload (reference:
    MappingFailedException)."""
