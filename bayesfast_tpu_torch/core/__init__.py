from .module import Module, ModuleBase, Surrogate
from .density import DensityLite
from .pipeline import Pipeline, Density
from .sample import sample
from . import recipe
from .recipe import (OptimizeStep, SampleStep, PostStep, StaticSample,
                     DynamicSample, RecipeTrace, Recipe)

__all__ = ['Module', 'ModuleBase', 'Surrogate', 'DensityLite', 'Pipeline',
           'Density', 'sample', 'recipe', 'OptimizeStep', 'SampleStep',
           'PostStep', 'StaticSample', 'DynamicSample', 'RecipeTrace',
           'Recipe']
