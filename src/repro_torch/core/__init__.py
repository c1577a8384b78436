"""CommonGraph core of the PyTorch port (counterpart of ``repro.core``).

Layers:
  ingest       live ingestion (edge-event log, watermark cuts, compaction)
  snapshots    mutation-free window/Δ representation (shared edge blocks)
  kickstarter  the streaming baseline (deletions + trimming) we compare to
  directhop    CommonGraph Direct-Hop schedule (deletion-free, star plan)
  trigrid      Triangular Grid + work-sharing plans (DP-optimal / bisection)
  window       sliding-window executors and streaming campaigns
  costmodel    measured-cost calibration for the Δ-volume planner
  service      always-on multi-client query service (admission + scheduling)
"""

from repro_torch.core.snapshots import CompactionStats, SnapshotStore
from repro_torch.core.ingest import (
    BackpressureStall,
    EdgeEvent,
    EdgeLog,
    IngestMetrics,
    LiveSequence,
    LiveWindowFeed,
    Watermark,
    events_from_sequence,
    replay_events,
)
from repro_torch.core.kickstarter import StreamStats, run_kickstarter_stream
from repro_torch.core.directhop import (
    DirectHopRun,
    run_direct_hop,
    run_direct_hop_batched,
)
from repro_torch.core.trigrid import (
    PlanNode,
    WorkSharingRun,
    bisection_plan,
    direct_hop_plan,
    hop_added_edges,
    optimal_plan,
    plan_added_edges,
    plan_levels,
    run_plan,
    run_plan_batched,
)
from repro_torch.core.costmodel import (
    SweepCostModel,
    calibrate,
    measure_sweep_nanos,
)
from repro_torch.core.service import (
    LaunchRecord,
    QueryService,
    ServiceClient,
    ServiceMetrics,
)
from repro_torch.core.window import (
    AnchorChain,
    CampaignPlan,
    WindowSlideRun,
    WindowStream,
    WindowStreamRun,
    campaign_volume,
    optimal_campaigns,
    run_window_slide,
    run_window_slide_batched,
    run_window_stream_batched,
    select_chain,
    slide_windows,
    stream_campaigns,
    window_anchor,
)

__all__ = [
    "AnchorChain",
    "BackpressureStall",
    "CampaignPlan",
    "CompactionStats",
    "EdgeEvent",
    "EdgeLog",
    "IngestMetrics",
    "LaunchRecord",
    "LiveSequence",
    "LiveWindowFeed",
    "Watermark",
    "events_from_sequence",
    "replay_events",
    "QueryService",
    "ServiceClient",
    "ServiceMetrics",
    "SweepCostModel",
    "calibrate",
    "measure_sweep_nanos",
    "WindowSlideRun",
    "WindowStream",
    "WindowStreamRun",
    "campaign_volume",
    "optimal_campaigns",
    "run_window_slide",
    "run_window_slide_batched",
    "run_window_stream_batched",
    "select_chain",
    "slide_windows",
    "stream_campaigns",
    "window_anchor",
    "SnapshotStore",
    "hop_added_edges",
    "StreamStats",
    "run_kickstarter_stream",
    "DirectHopRun",
    "run_direct_hop",
    "run_direct_hop_batched",
    "PlanNode",
    "WorkSharingRun",
    "bisection_plan",
    "direct_hop_plan",
    "optimal_plan",
    "plan_added_edges",
    "plan_levels",
    "run_plan",
    "run_plan_batched",
]
