from pydcop_tpu_torch.dcop.objects import (
    AgentDef,
    BinaryVariable,
    Domain,
    ExternalVariable,
    Variable,
    VariableDomain,
    VariableNoisyCostFunc,
    VariableWithCostDict,
    VariableWithCostFunc,
    create_agents,
    create_binary_variables,
    create_variables,
)
from pydcop_tpu_torch.dcop.relations import (
    AbstractBaseRelation,
    Constraint,
    NAryFunctionRelation,
    NAryMatrixRelation,
    RelationProtocol,
    UnaryFunctionRelation,
    assignment_cost,
    constraint_from_str,
    filter_assignment_dict,
    find_dependent_relations,
    optimal_cost_value,
    relation_from_str,
)
from pydcop_tpu_torch.dcop.dcop import DCOP, solution_cost
from pydcop_tpu_torch.dcop.yamldcop import (
    dcop_yaml,
    load_dcop,
    load_dcop_from_file,
    load_scenario,
    load_scenario_from_file,
)
from pydcop_tpu_torch.dcop.scenario import EventAction, Scenario, ScenarioEvent
