"""Notifications — task/resource event fan-out.

Rebuild of reference ``integrations/slack_client.go``: pluggable
channels receive resource-status and task-run events.  Ships a log
channel, a JSON-lines file channel, and a Slack-shaped HTTP webhook
channel (``WebhookChannel`` — points at any collector; in this
no-egress image it is exercised against a loopback server).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Protocol

from embeddinghub_tpu_torch.featurestore.logging import LOGGER


class Channel(Protocol):
    def notify(self, event: dict) -> None: ...


class LogChannel:
    def notify(self, event: dict) -> None:
        LOGGER.info("notification", **event)


class FileChannel:
    """JSON-lines event sink (stand-in for a webhook in a no-egress env)."""

    def __init__(self, path: str):
        self._path = Path(path)
        self._path.parent.mkdir(parents=True, exist_ok=True)

    def notify(self, event: dict) -> None:
        with open(self._path, "a") as f:
            f.write(json.dumps({"ts": time.time(), **event}) + "\n")


_STATUS_COLORS = {  # reference slack_messages.go GetColorForStatus
    "READY": "#00FF00",
    "FAILED": "#FF0000",
    "PENDING": "#FFA500",
    "RUNNING": "#FFA500",
}


class WebhookChannel:
    """HTTP POST JSON events to a webhook URL, Slack-attachment shaped
    (reference ``integrations/slack_client.go`` PostStatusChangeMessage:
    Type/Resource/Status/Error sections + a status color)."""

    def __init__(self, url: str, timeout: float = 5.0,
                 dashboard_url: str = ""):
        self.url = url
        self.timeout = timeout
        self.dashboard_url = dashboard_url

    def notify(self, event: dict) -> None:
        import urllib.request

        status = str(event.get("status", ""))
        fields = [
            {"title": k.replace("_", " ").title(), "value": str(v)}
            for k, v in event.items()
            if v not in ("", None)
        ]
        payload = {
            "attachments": [
                {
                    "color": _STATUS_COLORS.get(status, "#CCCCCC"),
                    "fields": fields,
                    **(
                        {"actions": [{"type": "button",
                                      "text": "View Dashboard",
                                      "url": self.dashboard_url}]}
                        if self.dashboard_url
                        else {}
                    ),
                }
            ],
            "event": event,
        }
        req = urllib.request.Request(
            self.url,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        urllib.request.urlopen(req, timeout=self.timeout).read()


class Notifier:
    def __init__(self, channels: list[Channel] | None = None):
        self.channels = channels if channels is not None else [LogChannel()]

    def resource_status(self, rid_key: str, status: str, error: str = "") -> None:
        self._fan_out(
            {"kind": "resource_status", "resource": rid_key, "status": status,
             "error": error}
        )

    def task_run(self, task: str, run_id: int, status: str, error: str = "") -> None:
        self._fan_out(
            {"kind": "task_run", "task": task, "run_id": run_id,
             "status": status, "error": error}
        )

    def _fan_out(self, event: dict) -> None:
        for ch in self.channels:
            try:
                ch.notify(event)
            except Exception:  # noqa: BLE001 — notification failure is non-fatal
                pass


NOTIFIER = Notifier()
