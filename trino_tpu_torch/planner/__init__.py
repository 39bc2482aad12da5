"""Logical planning: plan nodes, analyzer/planner, optimizer, fragmenter.

Reference: ``core/trino-main/src/main/java/io/trino/sql/planner/`` —
``LogicalPlanner.java:190``, plan nodes under ``sql/planner/plan/`` (44
types), optimizer sequence ``PlanOptimizers.java:240``, fragmenter
``PlanFragmenter.java:88``.
"""
