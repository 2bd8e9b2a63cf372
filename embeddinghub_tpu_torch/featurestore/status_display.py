"""Live status display for ``client.apply()``.

Rebuild of the reference client's apply-time status table
(``client/src/featureform/status_display.py:47-252``): a rich Live
table polling each submitted resource's status until every one reaches
READY or FAILED, coloring statuses (green/red/yellow) and surfacing
errors inline.  Differences from the reference are deliberate:

* statuses come straight from the in-process :class:`MetadataStore`
  instead of a gRPC round-trip per resource per tick;
* non-TTY / ``plain=True`` mode prints one line per status *change*
  (CI-friendly) instead of repainting a table;
* ``verbose`` raises at the end when anything FAILED, exactly like the
  reference's verbose mode (status_display.py:240-244).
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

from embeddinghub_tpu_torch.featurestore.resources import (
    Resource,
    ResourceType,
    Status,
)

SECONDS_BETWEEN_STATUS_CHECKS = 0.1
NUM_DISPLAY_ROWS = 25

# resource classes whose status is worth tracking (the reference's
# RESOURCE_TYPES_TO_CHECK; providers/users/entities are upserts that
# never run tasks here, so they're READY on create)
_TRACKED = {
    ResourceType.FEATURE_VARIANT,
    ResourceType.LABEL_VARIANT,
    ResourceType.SOURCE_VARIANT,
    ResourceType.TRAINING_SET_VARIANT,
}

_FINISHED = {Status.READY, Status.FAILED}

_COLOR = {
    "READY": "green",
    "PENDING": "white",
    "RUNNING": "yellow",
    "FAILED": "red",
    "DELETING": "magenta",
}


@dataclass
class _Row:
    rtype: str
    name: str
    variant: str
    status: str = "PENDING"
    error: str = ""
    ticks: int = 0
    rid: object = None

    def finished(self) -> bool:
        return self.status in ("READY", "FAILED")


@dataclass
class StatusDisplayer:
    metadata: object
    resources: list
    verbose: bool = False
    plain: bool | None = None   # None = auto (TTY check)
    poll_s: float = SECONDS_BETWEEN_STATUS_CHECKS
    timeout_s: float = 600.0
    out: object = None
    rows: list = field(default_factory=list)
    did_error: bool = False

    def __post_init__(self) -> None:
        self.out = self.out or sys.stdout
        if self.plain is None:
            self.plain = not getattr(self.out, "isatty", lambda: False)()
        for r in self.resources:
            if isinstance(r, Resource) and r.rtype in _TRACKED:
                self.rows.append(
                    _Row(
                        rtype=r.rtype.value,
                        name=r.name,
                        variant=getattr(r, "variant", ""),
                        rid=r.rid(),
                    )
                )

    # ------------------------------------------------------------- polling

    def refresh(self) -> bool:
        """Pull current statuses; returns True when anything changed."""
        changed = False
        for row in self.rows:
            if row.finished():
                continue
            res = self.metadata.maybe_get(row.rid)
            if res is None:
                continue
            status, error = res.status.value, res.status_error
            if (status, error) != (row.status, row.error):
                row.status, row.error = status, error
                changed = True
                if status == "FAILED":
                    self.did_error = True
        return changed

    def all_finished(self) -> bool:
        return all(r.finished() for r in self.rows)

    # ----------------------------------------------------------- rendering

    def _table(self):
        from rich.table import Table

        t = Table(title="apply status")
        t.add_column("Resource Type")
        t.add_column("Name (Variant)")
        t.add_column("Status")
        t.add_column("Error", overflow="fold")
        for row in self.rows[:NUM_DISPLAY_ROWS]:
            dots = "." * (1 + row.ticks % 3) if not row.finished() else ""
            t.add_row(
                row.rtype,
                f"{row.name} ({row.variant})",
                f"[{_COLOR.get(row.status, 'white')}]{row.status}{dots}[/]",
                row.error or "",
            )
            row.ticks += 1
        return t

    def _print_changes(self) -> None:
        for row in self.rows:
            key = (row.status, row.error)
            if getattr(row, "_printed", None) != key:
                row._printed = key
                line = f"{row.rtype} {row.name} ({row.variant}): {row.status}"
                if row.error:
                    line += f" — {row.error}"
                print(line, file=self.out, flush=True)

    # --------------------------------------------------------------- display

    def display(self, until=None) -> None:
        """Poll + render until all tracked resources finish (or ``until``
        — a callable returning True when the apply worker is done — says
        there is nothing left to wait for)."""
        if not self.rows:
            return
        deadline = time.monotonic() + self.timeout_s

        def done() -> bool:
            if self.all_finished():
                return True
            if until is not None and until():
                self.refresh()
                return True
            return time.monotonic() > deadline

        if self.plain:
            while True:
                self.refresh()
                self._print_changes()
                if done():
                    break
                time.sleep(self.poll_s)
        else:
            from rich.console import Console
            from rich.live import Live

            console = Console(file=self.out)
            with Live(console=console, auto_refresh=False) as live:
                while True:
                    self.refresh()
                    live.update(self._table(), refresh=True)
                    if done():
                        break
                    time.sleep(self.poll_s)

        if self.verbose and self.did_error:
            failed = [
                f"{r.name} ({r.variant}): {r.error}"
                for r in self.rows
                if r.status == "FAILED"
            ]
            raise Exception(
                "Some resources failed to create\n" + "\n".join(failed)
            )


def display_statuses(metadata, resources, verbose=False, **kw) -> None:
    """Reference ``display_statuses(grpc_client, resources, host)``."""
    StatusDisplayer(metadata, resources, verbose=verbose, **kw).display()
