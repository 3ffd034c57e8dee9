"""Port of ``keystone_tpu.workflow``: graph IR, operators, executor,
optimizer (with chain fusion and streaming), typed API."""

from .graph import Graph, NodeId, SinkId, SourceId
from .operators import (
    DatasetOperator,
    DatumOperator,
    DelegatingOperator,
    EstimatorOperator,
    Expression,
    ExpressionOperator,
    Operator,
    TransformerOperator,
)
from .executor import GraphExecutor, PipelineEnv
from .pipeline import (
    BatchTransformer,
    Chainable,
    Estimator,
    FittedPipeline,
    Identity,
    LabelEstimator,
    Pipeline,
    PipelineDataset,
    PipelineDatum,
    PipelineResult,
    Transformer,
)
from .prefix import Prefix, find_prefix
from .rules import (
    Batch,
    EquivalentNodeMergeRule,
    Rule,
    RuleExecutor,
    UnusedBranchRemovalRule,
    default_optimizer,
)
from .optimize import DataStats, NodeOptimizationRule, Optimizable
from .fusion import (
    FusedTransformerOperator,
    NodeFusionRule,
    fuse_graph,
    fusion_disabled,
    fusion_enabled,
    set_fusion_enabled,
)
from .streaming import (
    ChunkStream,
    StreamingFitOperator,
    StreamingPlanRule,
    last_stream_report,
    set_streaming_enabled,
    stream_pipelined,
    streaming_disabled,
    streaming_enabled,
)
from .tracing import PipelineTrace, current_trace, trace
